"""No-op evaluator (counterpart of ``ppst_tpu/evaluation/none_evaluator.py``)."""

from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator


class NoneEvaluator(BaseEvaluator):
    pass
