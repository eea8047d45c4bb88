"""The fused StyledConv's roofline files (K6 and K6-bwd) and their metrics'
readers: the bounds at the record shape, the sites a traced run wraps and
undoes, a program without a site, and a trace in which K1's and K6's
launches share names."""

import re
from types import SimpleNamespace

import pytest
import torch

from harness import peaks, program, readers, sites, spec
from harness.run_record import Run
from harness.trace import Event, Trace

BW, FLOPS = peaks.of("NVIDIA H100 80GB HBM3")
CELLS = {"ppst512.stylize.b8.fsc": ["styled_conv"],
         "ppst512.train.b2.fsc": ["styled_conv", "styled_conv_bwd"]}


def bound_ms(kernel, shape):
    rf = spec.roofline(kernel)
    return max(rf.ops(shape) / FLOPS, rf.bytes_moved(shape) / BW) * 1e3


@pytest.mark.parametrize("kernel, shape, gflop, ms", [
    ("styled_conv", (8, 512, 512, 128, 128), 618.5, 0.6254),
    ("styled_conv", (16, 512, 512, 128, 128), None, 1.2507),
    ("styled_conv", (8, 64, 64, 256, 384), None, 0.0586),
    ("styled_conv", (8, 64, 64, 512, 512), None, 0.1563),
    ("styled_conv_bwd", (8, 512, 512, 128, 128, 1), 1237.0, 1.2507),
    ("styled_conv_bwd", (16, 512, 512, 128, 128, 1), None, 2.5014),
    ("styled_conv_bwd", (8, 64, 64, 256, 384, 1), None, 0.1173),
])
def test_bounds_of_section_6(kernel, shape, gflop, ms):
    if gflop is not None:
        assert round(spec.roofline(kernel).ops(shape) / 1e9, 1) == gflop
    assert round(bound_ms(kernel, shape), 4) == ms


def test_the_backward_without_dx_is_bound_below_it():
    rf = spec.roofline("styled_conv_bwd")
    with_dx, without = (8, 512, 512, 128, 128, 1), (8, 512, 512, 128, 128, 0)
    assert bound_ms("styled_conv_bwd", without) < bound_ms("styled_conv_bwd", with_dx)
    assert rf.bytes_moved(without) < rf.bytes_moved(with_dx)


@pytest.mark.parametrize("kernel", ["styled_conv", "styled_conv_bwd"])
def test_the_sites_read_the_program_spans_shapes(kernel):
    """A call's shape is the one the program's ``ppst.op:`` span gives it."""
    rf = spec.roofline(kernel)
    x, w = torch.empty((2, 8, 8, 16)), torch.empty((32, 16, 3, 3))
    args = (x, w) + (None,) * 6 + ((True,) if kernel == "styled_conv_bwd" else ())
    want = (2, 8, 8, 16, 32) + ((1,) if kernel == "styled_conv_bwd" else ())
    assert tuple(rf.shape(args, {})) == want
    if kernel == "styled_conv_bwd":
        assert rf.shape(args[:8] + (False,), {})[-1] == 0


def test_the_cells_read_their_kernels_and_no_other_cell_does():
    for name in ("ppst512.train.b2", "ppst512.stylize.b8", "ppst512.stylize.b1",
                 "ppst1024.stylize.b1"):
        assert not {"styled_conv", "styled_conv_bwd"} & set(sites.kernels_of(spec.cell(name)))
    for name, kernels in CELLS.items():
        got = sites.kernels_of(spec.cell(name))
        assert [k for k in got if k.startswith("styled_conv")] == kernels


def test_wrapping_the_sites_keeps_the_launch_counters():
    """The program's counters stay readable and counting with both sites
    wrapped, as the drivers read them inside a traced window: the backward's
    counter lives on ``styled_conv3x3_bwd``, the wrapped name launches."""
    import ppst_tpu_torch.nn.layers as layers
    from ppst_tpu_torch.ops import styled_conv_cuda as sc

    raw = layers.styled_conv3x3, sc._bwd_cuda
    undo = sites.install(["styled_conv", "styled_conv_bwd"])
    try:
        assert layers.styled_conv3x3.__wrapped__ is raw[0] and sc._bwd_cuda.__wrapped__ is raw[1]
        assert set(program.launches()) >= {"styled_conv", "styled_conv_bwd"}
    finally:
        sites.remove(undo)
    assert (layers.styled_conv3x3, sc._bwd_cuda) == raw


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_traced_run_wraps_the_sites_and_undoes_them(small_cell, monkeypatch, name):
    """A traced run of the narrow cell on the CPU: the K6 site is called in
    every G pass (its shapes in the trace, as (B, H, W, Cin, Cout)), both
    sites are wrapped for the window and undone after it. On the CPU the
    backward runs its plain version, so ``_bwd_cuda`` is wrapped and not
    called."""
    import ppst_tpu_torch.nn.layers as layers
    from ppst_tpu_torch.ops import styled_conv_cuda as sc

    raw = layers.styled_conv3x3, sc._bwd_cuda
    installed = []
    install = sites.install
    monkeypatch.setattr(sites, "install", lambda ks: installed.append(install(ks)) or installed[-1])
    cell = small_cell(name)
    cell.traffic = dict(cell.traffic, trace_after=0.0, trace_units=1)
    run = Run(cell=cell, seed=2**31 + 29, seconds=0.5, traced=True, device=torch.device("cpu"))
    spec.driver(cell.traffic["driver"]).run(run, 0.0)
    assert [(owner.__name__, attr) for owner, attr, _ in installed[0]] == [
        ("ppst_tpu_torch.nn.layers", "styled_conv3x3"),
        ("ppst_tpu_torch.ops.styled_conv_cuda", "_bwd_cuda")][:len(CELLS[name])]
    assert (layers.styled_conv3x3, sc._bwd_cuda) == raw
    unit = run.trace.units[0].name
    calls = run.trace.site_shapes("styled_conv")
    # 11 non-upsampled StyledConvs a G pass: 2 passes a request, 6 a G step
    # (its forward's 3 and the checkpoints' 3 recomputes)
    assert len(calls) == 11 * {"request": 2, "G": 6}[unit]
    assert all(len(s) == 5 for s in calls)
    assert any(s[3] != s[4] for s in calls)
    assert readers.roofline_pct(run, "styled_conv") is None  # no device kernels on the CPU


def test_a_program_without_the_sites_reads_nothing(monkeypatch):
    import ppst_tpu_torch.nn.layers as layers
    from ppst_tpu_torch.ops import styled_conv_cuda as sc

    monkeypatch.delattr(sc, "_bwd_cuda")
    reader = spec.metric_reader("styled_conv_bwd_roofline.train.fsc")
    assert getattr(reader, "KERNEL", None) is None
    assert spec.metric_reader("styled_conv_roofline.train.fsc").KERNEL == "styled_conv"
    assert sites.kernels_of(spec.cell("ppst512.train.b2.fsc")) == ["styled_conv"]
    monkeypatch.delattr(layers, "styled_conv3x3")
    assert getattr(spec.metric_reader("styled_conv_roofline.batch.fsc"), "KERNEL", None) is None
    assert sites.kernels_of(spec.cell("ppst512.stylize.b8.fsc")) == []
    assert reader.read(SimpleNamespace(trace=None)) is None


def _dev(name, start, launched):
    return Event(name, start, start + 100, launched=launched)


def test_shared_kernel_names_are_counted_by_their_own_site_only():
    """K1 and K6 each launch a ``stats_kernel`` and an ``apply_kernel`` (in
    anonymous namespaces): each reader counts the launches made inside its
    own site's spans once, and never another's."""
    ns = "(anonymous namespace)::"
    calls = [Event("tap_fwd:2,512,512,128", 0, 50),
             Event("styled_conv:2,512,512,128,128", 60, 90),
             Event("styled_conv_bwd:2,512,512,128,128,1", 100, 190)]
    device = [  # K1's four launches, K6's three, K6-bwd's six (dx through the conv)
        _dev(ns + "stats_kernel(CUtensorMap_st, float*, Sched)", 1000, 10),
        _dev(ns + "conv_kernel(CUtensorMap_st, CUtensorMap_st)", 1100, 11),
        _dev(ns + "conv_kernel(CUtensorMap_st, CUtensorMap_st)", 1200, 12),
        _dev(ns + "apply_kernel(CUtensorMap_st, float const*)", 1300, 13),
        _dev(ns + "conv3x3_kernel<true>(CUtensorMap_st, CUtensorMap_st)", 1400, 61),
        _dev(ns + "moments_kernel(float const*, float*, float*, int, int, float)", 1500, 62),
        _dev(ns + "apply_kernel(__nv_bfloat16 const*, float const*)", 1600, 63),
        _dev(ns + "stats_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*)", 1700, 101),
        _dev(ns + "group_sum_kernel(float const*, float*, int, int, int, float)", 1800, 102),
        _dev(ns + "dpre_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*)", 1900, 103),
        _dev(ns + "dw_kernel(CUtensorMap_st, CUtensorMap_st, float*)", 2000, 104),
        _dev(ns + "dw_reduce_kernel(float const*, float*, int, int, int)", 2100, 105),
        _dev(ns + "conv3x3_kernel<false>(CUtensorMap_st, CUtensorMap_st)", 2200, 106),
        _dev("void at::native::elementwise_kernel<128, 4>()", 2300, 107),
    ]
    tr = Trace([Event("G", 0, 3000)], calls, device, [], 0, 3000)
    want = {"tap_fwd": 4, "styled_conv": 3, "styled_conv_bwd": 6}
    for kernel, n in want.items():
        pattern = spec.roofline(kernel).KERNELS
        assert tr.kernel_seconds(pattern, kernel) == (n * 100 / 1e9, n)
        # the names alone would take in another kernel's launches too
        assert sum(bool(re.search(pattern, e.name)) for e in device) > n
    run = SimpleNamespace(trace=tr, peaks=(BW, FLOPS))
    for kernel in want:
        shape = next(tuple(int(v) for v in e.name.partition(":")[2].split(","))
                     for e in calls if e.name.partition(":")[0] == kernel)
        share = readers.roofline_pct(run, kernel)
        assert share == pytest.approx(100 * bound_ms(kernel, shape) / 1e3
                                      / (want[kernel] * 100 / 1e9))
