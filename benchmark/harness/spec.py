"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<name>.json`` (through the ``file`` its
entry names), its traffic ``traffic/<traffic>.json``, its own numbers (FLOP
counts, correctness limits) ``workloads/<cell>.json``, each metric's reader
``metrics/<metric>.py`` (or that of the name before its first dot) and each
kernel's operations and bytes ``roofline/<kernel>.py``. A new cell,
configuration, traffic mix or metric is a new file and a new entry: nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (``metrics/x.train.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    config: dict  # configs/<file>
    traffic: dict  # traffic/<traffic>.json
    own: dict  # workloads/<cell>.json
    end_to_end: list  # the entries of the end-to-end metrics it reports
    per_layer: list  # the entries of the per-layer metrics it reports


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec_path: Path = SPEC) -> Cell:
    spec = load_json(spec_path)
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in {spec_path.name}; there are "
                       + ", ".join(w["name"] for w in spec["workloads"]))
    entry = entries[0]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry, config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        own=load_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def metric_reader(name: str):
    """``metrics/<name>.py``: ``read(run) -> float | None``. A metric split by
    the end-to-end metric it moves (``mfu.train``, ``mfu.batch``) that has no
    file of its own is read by the file of the name before its first dot
    (``metrics/mfu.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"bench_metric_{name}")


def roofline(kernel: str):
    """``roofline/<kernel>.py``: the kernel's call site, the shape of a call,
    its operations and bytes, and the names of its device kernels."""
    return load_module(BENCH / "roofline" / f"{kernel}.py", f"bench_roofline_{kernel}")


def driver(kind: str):
    """``drivers/<kind>.py``: ``run(ctx) -> Window``."""
    return load_module(BENCH / "drivers" / f"{kind}.py", f"bench_driver_{kind}")
