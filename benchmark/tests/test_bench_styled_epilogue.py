"""The StyledConv epilogue's roofline file and its metrics' reader: the bound
at the record shape, the site a traced run wraps, and a program without that
site (a checkout from before the op), where the reader names no kernel and
the traced run goes on without it."""

import pytest

from harness import peaks, sites, spec

BW, FLOPS = peaks.of("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("shape, mb, ms", [
    ((16, 512, 512, 128), 2155.9, 0.6435),
    ((2, 1024, 1024, 128), 1077.9, 0.3218),
    ((1, 64, 64, 512), 8.4, 0.0025),
])
def test_bound(shape, mb, ms):
    rf = spec.roofline("styled_epilogue")
    assert round(rf.bytes_moved(shape) / 1e6, 1) == mb
    assert rf.ops(shape) / FLOPS < rf.bytes_moved(shape) / BW
    assert round(rf.bytes_moved(shape) / BW * 1e3, 4) == ms


def test_the_cells_wrap_the_site_and_undo_it():
    import ppst_tpu_torch.nn.layers as layers

    raw = layers.styled_epilogue
    for cell in ("ppst512.stylize.b8", "ppst1024.stylize.b1"):
        assert "styled_epilogue" in sites.kernels_of(spec.cell(cell))
    assert "styled_epilogue" not in sites.kernels_of(spec.cell("ppst512.stylize.b1"))
    undo = sites.install(["styled_epilogue"])
    assert layers.styled_epilogue is not raw and layers.styled_epilogue.__wrapped__ is raw
    sites.remove(undo)
    assert layers.styled_epilogue is raw


def test_a_program_without_the_site_reads_nothing(monkeypatch):
    import ppst_tpu_torch.nn.layers as layers

    monkeypatch.delattr(layers, "styled_epilogue")
    reader = spec.metric_reader("styled_epilogue_roofline.batch")
    assert getattr(reader, "KERNEL", None) is None
    assert sites.kernels_of(spec.cell("ppst512.stylize.b8")) == ["tap_fwd"]
