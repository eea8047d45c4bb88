"""``harness.stages`` gives back known device and idle milliseconds from
hand-built traces, and the stage metrics' readers read them, or nothing
where the program opens no such span."""

from types import SimpleNamespace

import pytest

from harness import spec, stages
from harness.trace import Event, Trace, _merge

MS = 1_000_000  # ns


def _ev(name, a, b, launched=None):
    return Event(name, a * MS, b * MS, None if launched is None else launched * MS)


def _trace(units, host, device):
    """A reduced trace from (name, start, end[, launched]) in ms."""
    units = [_ev(*u) for u in units]
    device = sorted((_ev(*d) for d in device), key=lambda e: e.start)
    tr = Trace(units, [], device, [_ev(*h) for h in host], units[0].start, units[-1].end)
    tr.intervals = _merge(tr.device, tr.start, tr.end)
    return SimpleNamespace(trace=tr)


@pytest.fixture
def steps():
    """G, D, G steps of 1000 ms. In the first G step: forward 100-400, in
    which A runs and B is launched (B runs on past the span's end);
    backward 400-800, with a span of the same name nested in it (450-500)
    and the wrapper's span 500-600, in which C is launched, as autograd's
    thread launches in a backward; H launched in both backward spans.
    Forward 1100-1300 in the D step, 2100-2400 in the second G step; a
    copy with no launch in the trace (F) at 2500."""
    units = [("G", 0, 1000), ("D", 1000, 2000), ("G", 2000, 3000)]
    host = [("ppst.step:forward", 100, 400), ("ppst.step:backward", 400, 800),
            ("ppst.step:backward", 450, 500), ("ppst.op:tap_bwd:2,64,64,128,1", 500, 600),
            ("aten::mul", 510, 520), ("ppst.step:forward", 1100, 1300),
            ("ppst.step:r1", 1300, 1400), ("ppst.step:forward", 2100, 2400)]
    device = [("A", 200, 300, 150), ("B", 400, 700, 390), ("C", 700, 750, 550),
              ("H", 750, 760, 460), ("D", 1200, 1250, 1150), ("E", 2200, 2300, 2150),
              ("F", 2500, 2600, None)]
    return _trace(units, host, device)


def test_device_ms_by_launch(steps):
    # A 100, B 300 whole though it outlasts its span, E 100; over 2 G steps
    assert stages.device_ms(steps, "ppst.step:forward", ("G",)) == pytest.approx(250)
    # the D step's 50 too, over 3 steps
    assert stages.device_ms(steps, "ppst.step:forward") == pytest.approx(550 / 3)


def test_nested_spans_count_once(steps):
    # C 50 (launched inside the wrapper's span, in the backward) and H 10
    # (inside both backward spans, once), over 2 G steps
    assert stages.device_ms(steps, "ppst.step:backward", ("G",)) == pytest.approx(30)
    assert stages.device_ms(steps, "ppst.op:tap_bwd:2,64,64,128,1") == pytest.approx(50 / 3)


def test_idle_ms(steps):
    # forward: 300 - 100 busy in the first G step, 300 - 100 in the second
    assert stages.idle_ms(steps, "ppst.step:forward", ("G",)) == pytest.approx(200)
    # backward 400-800: busy 400-760 (B, C, H merged), 40 idle
    assert stages.idle_ms(steps, "ppst.step:backward", ("G",)) == pytest.approx(20)
    # the D step's forward 1100-1300 holds D's 50
    assert stages.idle_ms(steps, "ppst.step:forward", ("D",)) == pytest.approx(150)


def test_kinds_filter_the_spans_by_the_unit_they_start_in(steps):
    assert stages.device_ms(steps, "ppst.step:r1", ("D",)) == 0
    assert stages.device_ms(steps, "ppst.step:r1", ("G",)) is None
    assert stages.idle_ms(steps, "ppst.step:r1", ("G",)) is None


def test_missing_span_or_trace_reads_nothing(steps):
    assert stages.device_ms(steps, "ppst.stylize:extract") is None
    assert stages.idle_ms(steps, "ppst.stylize:extract") is None
    none = SimpleNamespace(trace=None)
    assert stages.device_ms(none, "ppst.step:forward") is None
    assert stages.idle_ms(none, "ppst.step:forward") is None


def _stage_metrics():
    return [m for m in spec.load_json(spec.SPEC)["per_layer"] if m["layer"] == "stages"]


def test_the_stage_metrics():
    """22 entries: four stages' device ms in each serving cell, their idle ms
    in the host-bound one, and G's three phases in training, each in its one
    cell, moving that cell's end-to-end metric."""
    got = _stage_metrics()
    assert len(got) == 22
    cells = {c: m["name"] for m in spec.load_json(spec.SPEC)["end_to_end"]
             for c in m.get("workloads", [])}
    for m in got:
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "device_trace")
        (cell,) = m["workloads"]
        assert m["moves"] == cells[cell]


@pytest.mark.parametrize("metric", [m["name"] for m in _stage_metrics()])
def test_stage_readers_read_nothing_without_the_spans(steps, metric):
    """A program without the spans (the parent of this reader) reads
    nothing, and raises nothing."""
    reader = spec.metric_reader(metric)
    assert reader.read(SimpleNamespace(trace=None)) is None
    bare = _trace([("request", 0, 100)], [("aten::mul", 10, 20)], [("A", 10, 30, 15)])
    assert reader.read(bare) is None


@pytest.mark.parametrize("metric,want", [
    ("g_forward_device_ms.train", 250), ("g_backward_device_ms.train", 30),
    ("g_forward_idle_ms.train", 200), ("g_backward_idle_ms.train", 20),
])
def test_training_readers(steps, metric, want):
    assert spec.metric_reader(metric).read(steps) == pytest.approx(want)


def test_serving_readers():
    """Two requests; each stage's device and idle ms a request."""
    units = [("request", 0, 100), ("request", 100, 200)]
    host = []
    for r in (0, 100):
        host += [("ppst.stylize:extract", r + 0, r + 40), ("ppst.stylize:warp", r + 40, r + 50),
                 ("ppst.stylize:decode", r + 50, r + 80), ("ppst.stylize:filter", r + 80, r + 90)]
    device = [("e", 5, 45, 1), ("w", 45, 55, 41), ("d", 60, 80, 51), ("f", 80, 84, 81),
              ("e", 105, 135, 101), ("d", 150, 190, 151)]
    run = _trace(units, host, device)
    want = {"extract": (35, 7.5), "warp": (5, 5), "decode": (30, 2.5), "filter": (2, 3)}
    for stage, (dev, idle) in want.items():
        assert spec.metric_reader(f"{stage}_device_ms.batch").read(run) == pytest.approx(dev)
        assert spec.metric_reader(f"{stage}_idle_ms.interactive.512px").read(
            run) == pytest.approx(idle)
