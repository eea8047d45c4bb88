"""K8's roofline file and its metrics' reader: the bound at the path's
shapes, the shape a call through the site reads (as the program's own span
gives it), the site a traced run wraps, and a program without that site (a
checkout from before the op), where the reader names no kernel and the
traced run goes on without it."""

import pytest
import torch

from harness import peaks, sites, spec

BW, FLOPS = peaks.of("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("shape, mb, ms", [
    ((16, 512, 512, 32, 0, 32), 536.9, 0.1603),
    ((16, 256, 256, 256, 1, 257), 1610.6, 0.4808),
    ((16, 258, 258, 256, 0, 0), 1090.6, 0.3255),
    ((2, 1024, 1024, 32, 0, 32), 268.4, 0.0801),
])
def test_bound(shape, mb, ms):
    rf = spec.roofline("norm_act")
    assert round(rf.bytes_moved(shape) / 1e6, 1) == mb
    assert rf.ops(shape) / FLOPS < rf.bytes_moved(shape) / BW
    assert round(rf.bytes_moved(shape) / BW * 1e3, 4) == ms


def test_the_shape_of_a_call_is_its_span():
    from ppst_tpu_torch.util.spans import name_of

    rf = spec.roofline("norm_act")
    y = torch.zeros((2, 4, 6, 16), dtype=torch.bfloat16)
    bias, slope = torch.zeros(16), torch.zeros(1)
    for args, kwargs, want in [
        ((y, None, None, bias, None), {}, (2, 4, 6, 16, 0, 16)),
        ((y, bias, y, None, slope), {}, (2, 4, 6, 16, 1, 17)),
        ((y,), {"pre_bias": bias}, (2, 4, 6, 16, 0, 16)),
        ((y, None, None, None, None), {}, (2, 4, 6, 16, 0, 0)),
    ]:
        assert rf.shape(args, kwargs) == want
    # the program's span names the same numbers (ops/norm_act_cuda.py)
    assert name_of("op:norm_act", y.shape, True, 17) == "ppst.op:norm_act:2,4,6,16,1,17"


def test_the_cells_wrap_the_site_and_undo_it():
    import ppst_tpu_torch.nn.layers as layers

    raw = layers.norm_act
    for cell in ("ppst512.stylize.b8", "ppst1024.stylize.b1"):
        assert "norm_act" in sites.kernels_of(spec.cell(cell))
    assert "norm_act" not in sites.kernels_of(spec.cell("ppst512.stylize.b1"))
    undo = sites.install(["norm_act"])
    assert layers.norm_act is not raw and layers.norm_act.__wrapped__ is raw
    sites.remove(undo)
    assert layers.norm_act is raw


def test_a_program_without_the_site_reads_nothing(monkeypatch):
    import ppst_tpu_torch.nn.layers as layers

    monkeypatch.delattr(layers, "norm_act")
    reader = spec.metric_reader("norm_act_roofline.batch")
    assert getattr(reader, "KERNEL", None) is None
    assert "norm_act" not in sites.kernels_of(spec.cell("ppst512.stylize.b8"))
