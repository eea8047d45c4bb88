"""The program's spans (``ppst_tpu_torch/util/spans.py``) on the CPU at NARROW:
off without a profiler; under one, ``stylize``'s four stages and a training
step's phases once each, in order and apart, their names the facility's;
and the loop's sections, whose EMAs leave out their cold first sample."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from test_torch_train_common import NARROW, batch
from torch.profiler import ProfilerActivity, profile

from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
from ppst_tpu_torch.train import bundle as bundle_mod
from ppst_tpu_torch.train import cli
from ppst_tpu_torch.util import iter_counter, spans

PACKAGE = Path(__file__).resolve().parent.parent / "ppst_tpu_torch"
WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]
STAGES = ["extract", "warp", "decode", "filter"]
PHASES = ["forward", "backward", "update"]


def _ns(e, what):
    if hasattr(e, f"{what}_ns"):
        return getattr(e, f"{what}_ns")()
    return getattr(e, f"{what}_us")() * 1000


def _recorded(fn):
    """(name, start, end, is a user annotation) of every ``ppst.`` event that
    ``fn`` records under a CPU profiler, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            start = _ns(e, "start")
            out.append((e.name(), start, start + _ns(e, "duration"), e.is_user_annotation()))
    return sorted(out, key=lambda v: v[1])


def _opt(tmp, *extra):
    return cli.parse(["--device", "cpu", "--name", "run", "--checkpoints_dir", str(tmp),
                      "--dataset_mode", "synthetic", "--synthetic_size", "8",
                      "--crop_size", "64", "--load_size", "64", "--batch_size", "2",
                      "--nThreads", "1", *WIDTH_FLAGS, *extra])


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The ``ppst.`` events of each path, run once at NARROW."""
    tmp = tmp_path_factory.mktemp("spans")
    opt = _opt(tmp)
    bundle = bundle_mod.create_model(opt)
    optimizer = PPSTOptimizer(opt, bundle)
    model = bundle.model
    real, mask = batch(seed=5)
    data = {"real_A": real, "mask_A": mask}
    content, style = torch.from_numpy(real), torch.from_numpy(real[::-1].copy())
    gen = torch.Generator().manual_seed(0)
    steps = optimizer.steps
    r, m = torch.from_numpy(real), torch.from_numpy(mask)
    return {
        "stylize": _recorded(lambda: model.stylize(content, style, gen, smooth_target=True)),
        "stylize_fused": _recorded(
            lambda: model.stylize_fused(content, style, gen, smooth_target=True)),
        "train_one_step.D": _recorded(lambda: optimizer.train_one_step(data, 0)),
        "train_one_step.G": _recorded(lambda: optimizer.train_one_step(data, 2)),
        "d_step": _recorded(lambda: steps.d_step(r, m, bundle.generator)),
        "d_step_r1": _recorded(lambda: steps.d_step_r1(r, m, bundle.generator)),
        "g_step": _recorded(lambda: steps.g_step(r, m, bundle.generator)),
        "save": _recorded(lambda: bundle.save(0)),
    }


def _layer(events, layer):
    return [e for e in events if e[0].startswith(f"{spans.PREFIX}{layer}:")]


def _apart(events):
    return all(a[2] <= b[1] for a, b in zip(events, events[1:]))


def test_off_without_a_profiler(monkeypatch):
    """No profiler: every span is the one shared null context, and no
    profiler span is made (formatting the name included)."""
    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "name_of", refuse)
    got = spans.span("stylize:extract")
    assert got is spans.span("op:tap_fwd", torch.Size([2, 64, 64, 128])) is spans._OFF
    with got:
        pass


@pytest.mark.parametrize("path", ["stylize", "stylize_fused"])
def test_stylize_stages_in_order(recorded, path):
    stages = _layer(recorded[path], "stylize")
    assert [e[0] for e in stages] == [f"ppst.stylize:{s}" for s in STAGES]
    assert _apart(stages)


@pytest.mark.parametrize("path,want", [
    ("g_step", PHASES), ("d_step", PHASES), ("d_step_r1", PHASES * 2),
    ("train_one_step.D", ["inputs", *PHASES, "fetch"]),
    ("train_one_step.G", ["inputs", *PHASES, "fetch"]),
])
def test_step_phases_in_order(recorded, path, want):
    """Each update's forward, backward and update once, in order and apart (a
    D+R1 step's twice); the optimizer's copy in and fetch around them; no
    collective in a world of one."""
    phases = _layer(recorded[path], "step")
    assert [e[0] for e in phases] == [f"ppst.step:{p}" for p in want]
    assert _apart(phases)


def test_save_is_a_span(recorded):
    assert [e[0] for e in recorded["save"]] == ["ppst.ckpt:save"]


@pytest.mark.parametrize("path", ["stylize", "stylize_fused", "train_one_step.D",
                                  "train_one_step.G", "d_step", "d_step_r1", "g_step", "save"])
def test_recorded_names_follow_the_scheme(recorded, path):
    """What the program records is a user annotation named ``ppst.<layer>:
    <stage>`` with no ``Launch`` in it: a trace reader files it as a host
    operation, never as a device operation or a runtime launch."""
    events = recorded[path]
    assert events
    for name, _, _, annotation in events:
        assert annotation, name
        assert re.fullmatch(r"ppst\.[a-z]+:[a-z_]+(:[0-9,]+)?", name), name
        assert "Launch" not in name


def test_source_spans_follow_the_scheme():
    """Every span the package opens goes through ``util.spans.span`` with a
    literal ``<layer>:<stage>`` name (the loop's ``loop:<section>`` and the
    kernel wrappers' shapes apart), and no other module opens a profiler
    span of its own."""
    names = []
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        if path.name != "spans.py":
            assert "record_function" not in text, path
        names += re.findall(r"\bspan\(\"([^\"]*)\"\s*[,)]", text)
    assert len(set(names)) >= 16
    for name in names:
        assert re.fullmatch(r"[a-z]+:[a-z_]+", name) and "Launch" not in name, name
    assert {f"stylize:{s}" for s in STAGES} | {f"step:{p}" for p in PHASES} <= set(names)


@pytest.mark.parametrize("name,dims,want", [
    ("op:tap_fwd", (torch.Size([2, 64, 64, 128]),), "ppst.op:tap_fwd:2,64,64,128"),
    ("op:tap_bwd", (torch.Size([4, 512, 512, 128]), 1), "ppst.op:tap_bwd:4,512,512,128,1"),
    ("op:corr_warp", (torch.Size([1, 16384]), 16384, 512, 256, 2),
     "ppst.op:corr_warp:1,16384,16384,512,256,2"),
])
def test_shapes_in_names(name, dims, want):
    """A wrapper's shape reads as the benchmark's call-site spans write it:
    the ints joined by commas."""
    assert spans.name_of(name, *dims) == want


def test_span_closes_when_its_body_raises():
    def body():
        with pytest.raises(ValueError):
            with spans.span("test:raises"):
                raise ValueError
        with spans.span("test:after"):
            pass

    (raised, s0, e0, _), (after, s1, _, _) = _recorded(body)
    assert (raised, after) == ("ppst.test:raises", "ppst.test:after")
    assert s0 < e0 <= s1


def test_loop_sections_leave_out_their_first_sample(tmp_path, monkeypatch):
    """Each section's EMA starts from its second sample (the first, cold one
    left out: until then the section has no time), then moves by 2% a
    sample; each section is a span."""
    clock = iter([0.0, 10.0, 10.0, 10.2, 20.0, 20.4, 30.0, 30.1])
    monkeypatch.setattr(iter_counter, "time", SimpleNamespace(time=lambda: next(clock)))
    counter = iter_counter.IterationCounter(_opt(tmp_path))  # batch 2: seconds / 2 an image
    seen = []

    def sections():
        for name in ("data", "data", "data", "train"):
            with counter.time_measurement(name):
                pass
            seen.append(dict(counter.time_measurements))

    events = _recorded(sections)
    assert seen[0] == {} and seen[1] == {"data": pytest.approx(0.1)}
    assert seen[3] == {"data": pytest.approx(0.1 * 0.98 + 0.2 * 0.02)}
    assert [e[0] for e in events] == ["ppst.loop:data"] * 3 + ["ppst.loop:train"]
