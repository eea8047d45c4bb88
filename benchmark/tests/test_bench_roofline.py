"""The roofline files reproduce the bounds that PERF.md section 6 gives for
the kernels at their record shapes (NVIDIA H100 SXM: 3.35 TB/s, 989 TFLOP/s
bf16 dense)."""

import pytest

from harness import peaks, spec

BW, FLOPS = peaks.of("NVIDIA H100 80GB HBM3")


def bound_ms(kernel, shape):
    rf = spec.roofline(kernel)
    return max(rf.ops(shape) / FLOPS, rf.bytes_moved(shape) / BW) * 1e3


@pytest.mark.parametrize("kernel, shape, mb, ms", [
    ("tap_fwd", (2, 512, 512, 128), 201.4, 0.0601),
    ("tap_fwd", (16, 512, 512, 128), None, 0.4808),
    ("tap_fwd", (2, 1024, 1024, 128), None, 0.2404),
    ("tap_bwd", (4, 512, 512, 128, 0), 671.1, 0.2003),
    ("tap_bwd", (2, 1024, 1024, 128, 0), None, 0.4006),
    ("tap_bwd", (2, 1024, 1024, 128, 1), None, 0.5609),
    ("corr_warp", (1, 16384, 16384, 512, 32, 2), None, 0.2953),
    ("corr_warp", (1, 16384, 16384, 512, 64, 2), None, 0.3127),
    ("corr_warp", (1, 16384, 16384, 512, 128, 2), None, 0.3474),
    ("corr_warp", (1, 16384, 16384, 512, 256, 2), None, 0.4169),
    ("corr_warp", (8, 4096, 4096, 512, 256, 2), None, 0.2085),
])
def test_bounds_of_section_6(kernel, shape, mb, ms):
    if mb is not None:
        assert round(spec.roofline(kernel).bytes_moved(shape) / 1e6, 1) == mb
    assert round(bound_ms(kernel, shape), 4) == ms


@pytest.mark.parametrize("kernel", ["tap_fwd", "tap_bwd", "corr_warp"])
def test_roofline_files_name_a_site_and_their_kernels(kernel):
    import re

    rf = spec.roofline(kernel)
    module, _, attr = rf.SITE.partition(":")
    assert module.startswith("ppst_tpu_torch.") and attr
    re.compile(rf.KERNELS)


def test_peaks_of_unknown_card_raise():
    with pytest.raises(RuntimeError):
        peaks.of("a card with no data sheet")


def test_kernel_time_counts_only_what_its_wrapper_launched():
    """K1's ``apply_kernel`` and K6's share a name: only the launches made
    inside a call into the kernel's own wrapper count, and a matching
    launch that the trace cannot place counts nothing."""
    from harness.trace import Event, Trace

    def dev(name, start, launched):
        return Event(name, start, start + 100, launched=launched)

    sites = [Event("tap_fwd:2,512,512,128", 0, 50), Event("styled_conv:2,64,64,256", 60, 90)]
    device = [dev("(anonymous namespace)::apply_kernel(CUtensorMap_st)", 100, 10),
              dev("(anonymous namespace)::apply_kernel(__nv_bfloat16 const*)", 300, 70),
              dev("(anonymous namespace)::conv_kernel(CUtensorMap_st)", 500, 20),
              dev("void at::native::elementwise_kernel<128, 4>()", 700, None)]
    tr = Trace([Event("request", 0, 1000)], sites, device, [], 0, 1000)
    pattern = spec.roofline("tap_fwd").KERNELS
    assert tr.kernel_seconds(pattern, "tap_fwd") == (200 / 1e9, 2)
    assert tr.kernel_seconds(pattern, "styled_conv") == (100 / 1e9, 1)
    device[0].launched = None
    assert tr.kernel_seconds(pattern, "tap_fwd") == (0.0, 0)
