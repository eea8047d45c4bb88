"""Evaluator lookup (counterpart of ``ppst_tpu/evaluation/__init__.py``):
``--evaluation_metrics <metric>`` names ``<metric>_evaluator``.
``content_style_1t1_generation`` is an alias of the grid evaluator (the
reference launcher's metric name)."""

from __future__ import annotations

from ppst_tpu_torch.evaluation.content_style_grid_generation_evaluator import (
    ContentStyleGridGenerationEvaluator,
)
from ppst_tpu_torch.evaluation.simple_swapping_evaluator import SimpleSwappingEvaluator

EVALUATORS = {
    "simple_swapping": SimpleSwappingEvaluator,
    "content_style_grid_generation": ContentStyleGridGenerationEvaluator,
}
ALIASES = {"content_style_1t1_generation": "content_style_grid_generation"}


def find_evaluator_using_name(metric: str):
    return EVALUATORS[ALIASES.get(metric, metric)]
