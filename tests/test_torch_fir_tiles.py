"""K4's TMA route, emulated on the CPU: the persistent kernel of
``csrc/upfirdn2d.cu`` walks a static schedule of items (a sample, a strip of
``tw`` output columns x ``cg`` 16-byte channel groups, ``rh`` output rows)
laid out by the wrapper's ``tma_plan``; for each item it loads bands of
``rows`` input rows x ``bw`` columns as TMA boxes started at (ox0 down - p0,
oy0 down - p0) (negative starts and reads past the image come back as
zeros: the pad), sums each input row horizontally once, keeps the last T row
sums and weights them by the vertical taps at each kept output row. This
file emulates that schedule and arithmetic in torch and holds it to the
plain version ``upfirdn2d_cuda_reference`` within K4's tolerances
(``tools/k4_ab.py``'s ``within``, which ``chip_smoke.py`` applies on the
card), and at one small shape to ``ppst_tpu``'s Pallas kernel in
interpret mode; it also checks the wrapper's choice of route and that every
plan stays within the kernel's limits.

The kernel itself runs only on the card (``chip_smoke.py`` and
``ppst_tpu_torch/tools/k4_ab.py`` hold it against the same plain version).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas
from ppst_tpu_torch.ops import upfirdn2d_cuda as fir
from ppst_tpu_torch.tools.k4_ab import within

PADS = [(2, 1), (1, 1), (1, 2), (0, 0)]
# T = 3 asymmetric, so that a filter that does not flip its taps fails
TAPS = {1: [1.0], 3: [1.0, 2.0, 4.0], 4: [1.0, 3.0, 3.0, 1.0]}
# 17 channel groups of 16 bytes in either dtype (a ragged second channel
# strip of one group), 37 columns (three strips of 16, the last ragged)
SHAPES = {torch.bfloat16: (2, 11, 37, 136), torch.float32: (2, 11, 37, 68)}
SMS = 7  # an emulated card of 7 SMs: 14 blocks, several items each


def _box(x, c0, x0, y0, b, cge, bw, rows):
    """TMA's box of (cge, bw, rows, 1) elements at (c0, x0, y0, b) of the
    4-D map over (C, W, H, B) of NHWC ``x``, as (rows, bw, cge): elements
    outside the tensor read as zeros."""
    _, h, w, c = x.shape
    box = torch.zeros((rows, bw, cge), dtype=x.dtype)
    ylo, yhi = max(y0, 0), min(y0 + rows, h)
    xlo, xhi = max(x0, 0), min(x0 + bw, w)
    chi = min(c0 + cge, c)
    if ylo < yhi and xlo < xhi:
        box[ylo - y0 : yhi - y0, xlo - x0 : xhi - x0, : chi - c0] = x[b, ylo:yhi, xlo:xhi, c0:chi]
    return box


def _decode(i, plan):
    """Item i's (b, channel strip, ox0, oy0), channel strips fastest."""
    cs, i = i % plan.ncs, i // plan.ncs
    xs, i = i % plan.nxs, i // plan.nxs
    ys, b = i % plan.nys, i // plan.nys
    return b, cs, xs * plan.tw, ys * plan.rh


def emulate(x, taps, down, pad, sms=SMS):
    """The TMA route's output, computed as the kernel computes it (float32
    sums, one rounding at the store), and the plan; every output element is
    written exactly once."""
    nt = len(taps)
    plan = fir.tma_plan(tuple(x.shape), x.element_size(), nt, down, pad, sms)
    f = [float(v) for v in np.asarray(taps, np.float32)[::-1]]
    b_, _, _, c = x.shape
    oh, ow, tw, bw, rows = plan.oh, plan.ow, plan.tw, plan.bw, plan.rows
    cge = plan.cg * 16 // x.element_size()
    out = torch.zeros((b_, oh, ow, c))
    writes = torch.zeros((b_, oh, ow, c), dtype=torch.int32)
    for g in range(plan.grid):  # the static schedule: block g, items g, g + grid, ...
        for i in range(g, plan.items, plan.grid):
            b, cs, ox0, oy0 = _decode(i, plan)
            nin = (min(plan.rh, oh - oy0) - 1) * down + nt
            c0, ix0, iy0 = cs * cge, ox0 * down - pad[0], oy0 * down - pad[0]
            ncols, nch = min(tw, ow - ox0), min(cge, c - c0)
            hist = [torch.zeros((tw, cge))] * nt  # the last nt row sums, oldest first
            row = 0
            for k in range(-(-nin // rows)):
                band = _box(x, c0, ix0, iy0 + k * rows, b, cge, bw, rows).float()
                for r in range(min(rows, nin - k * rows)):
                    # thread j reads band columns j down + l, l < nt
                    h = torch.zeros((tw, cge))
                    for l in range(nt):
                        h = h + f[l] * band[r, l : l + (tw - 1) * down + 1 : down]
                    hist = hist[1:] + [h]
                    r0 = row - (nt - 1)
                    if r0 >= 0 and r0 % down == 0:
                        o = torch.zeros((tw, cge))
                        for kk in range(nt):
                            o = o + f[kk] * hist[kk]
                        oy = oy0 + r0 // down
                        out[b, oy, ox0 : ox0 + ncols, c0 : c0 + nch] = o[:ncols, :nch]
                        writes[b, oy, ox0 : ox0 + ncols, c0 : c0 + nch] += 1
                    row += 1
    assert bool((writes == 1).all()), "an output element was written other than once"
    return out.to(x.dtype), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("down", [1, 2])
@pytest.mark.parametrize("nt", [1, 3, 4])
@pytest.mark.parametrize("pad", PADS, ids=[f"pad{p0}{p1}" for p0, p1 in PADS])
def test_tma_emulation_matches_plain(rng, pad, nt, down, dtype):
    """The emulated TMA route against the plain version, with a ragged last
    channel strip and column strip; asymmetric taps and unequal pads catch a
    wrong flip or start."""
    taps = np.asarray(TAPS[nt], np.float32) / sum(TAPS[nt])
    x = torch.from_numpy(rng.standard_normal(SHAPES[dtype]).astype(np.float32)).to(dtype)
    got, plan = emulate(x, taps, down, pad)
    assert plan.ncs == 2 and plan.nxs * plan.tw > plan.ow
    want = fir.upfirdn2d_cuda_reference(x, taps, down=down, pad=pad)
    assert within(got, want)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("down", [1, 2])
def test_tma_emulation_ragged_bands_and_row_segments(rng, down, dtype):
    """A taller image on a larger emulated card: the plan cuts each strip
    into several row segments, the last one shorter, and items end in a
    partial band; the emulation still matches the plain version."""
    shape = (1, 37, 29, 64 if dtype == torch.bfloat16 else 32)  # 8 groups: cg 8, tw 29
    taps = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32) / 8
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    got, plan = emulate(x, taps, down, (2, 1), sms=16)
    nins = {(min(plan.rh, plan.oh - oy0) - 1) * down + 4
            for oy0 in range(0, plan.oh, plan.rh)}
    assert plan.nys > 1 and plan.oh % plan.rh and any(n % plan.rows for n in nins)
    assert within(got, fir.upfirdn2d_cuda_reference(x, taps, down=down, pad=(2, 1)))[0]


@pytest.mark.parametrize("down,pad", [(1, (2, 1)), (2, (1, 1))])
def test_tma_emulation_matches_pallas(rng, down, pad):
    """float32 at one small shape: the emulated TMA route against
    upfirdn2d_pallas in interpret mode, at test_upfirdn_pallas_matches_xla's
    1e-5."""
    x = rng.standard_normal((2, 12, 20, 16)).astype(np.float32)
    taps = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32) / 8
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), taps, down=down, pad=pad,
                                       channel_block=16))
    got, _ = emulate(torch.from_numpy(x), taps, down, pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _view(shape, dtype, offset=0):
    """A tensor of ``shape`` whose data pointer is ``offset`` elements past a
    fresh allocation (expanded from one pixel: no memory for large shapes)."""
    base = torch.empty(shape[-1] + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset : offset + shape[-1]].expand(shape)


def test_tma_route_choice():
    """The TMA route needs C * itemsize a multiple of 16 and both pointers
    16-byte aligned: chip_smoke.py's record and mid shapes and its odd
    float32 shape (C = 24) take it, its odd shapes of C = 20 bf16 (40 bytes)
    and C = 3 float32 (12 bytes) and misaligned views take the generic route;
    a CPU call counts no launch on either."""
    bf, f32 = torch.bfloat16, torch.float32
    out = torch.empty(16, dtype=bf)
    for shape, dt, route in [((8, 512, 512, 128), bf, True), ((8, 128, 128, 512), bf, True),
                             ((8, 256, 256, 256), bf, True), ((8, 512, 512, 128), f32, True),
                             ((3, 37, 21, 24), f32, True), ((2, 19, 33, 20), bf, False),
                             ((2, 19, 33, 3), f32, False),
                             ((1, 5, 5, 8), bf, True), ((1, 5, 5, 4), bf, False),
                             ((1, 5, 5, 4), f32, True), ((1, 5, 5, 3), f32, False)]:
        assert fir.tma_route(_view(shape, dt), out, 4) is route, (shape, dt)
    assert not fir.tma_route(_view((1, 5, 5, 8), bf, offset=1), out, 4)
    assert not fir.tma_route(_view((1, 5, 5, 8), bf), _view((1, 5, 5, 8), bf, offset=4), 4)
    assert fir.tma_route(_view((1, 5, 5, 8), bf, offset=8), out, 4)
    assert not fir.tma_route(_view((1, 5, 5, 8), bf), out, 9)
    before = dict(fir.upfirdn2d_cuda.route_launches)
    x = torch.ones((1, 6, 6, 8), dtype=bf)
    fir.upfirdn2d_cuda(x, np.ones(4) / 4, down=2, pad=(1, 1))
    assert fir.upfirdn2d_cuda.route_launches == before


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_tma_plan_within_kernel_limits(sms):
    """ppst_upfirdn2d_tma refuses a plan whose block needs more than 256
    consumer threads, a box side over 256, a band narrower than its columns
    or a ring over a block's shared memory, and one that does not cover the
    output: every plan the wrapper makes, at the paths' shapes and odd ones,
    in both dtypes, for 1-8 taps and both downs, passes those checks."""
    shapes = [(8, 512, 512, 128), (8, 128, 128, 512), (8, 256, 256, 256), (16, 512, 512, 128),
              (2, 1024, 1024, 128), (3, 37, 21, 24), (1, 8, 300, 8), (1, 300, 8, 2048)]
    for shape in shapes:
        for itemsize in (2, 4):
            if shape[3] * itemsize % 16:
                continue
            for nt in range(1, 9):
                for down in (1, 2):
                    p = fir.tma_plan(shape, itemsize, nt, down, (2, 1), sms)
                    assert 1 <= p.cg <= 16 and p.cg <= p.groups
                    assert p.tw * p.cg <= fir.TMA_CONSUMERS
                    assert p.cg * 16 // itemsize <= fir.MAX_BOX
                    assert (p.tw - 1) * down + nt <= p.bw <= fir.MAX_BOX
                    assert 1 <= p.rows <= fir.MAX_BOX and p.rh >= 1
                    assert p.stage % 128 == 0 and p.stage >= p.rows * p.bw * p.cg * 16
                    assert fir.RING_STAGES * p.stage + 128 + 16 * fir.RING_STAGES <= p.smem
                    assert p.smem <= fir.MAX_SMEM
                    assert 1 <= p.grid <= min(p.items, 2 * sms)
                    assert p.nxs * p.tw >= p.ow and p.nys * p.rh >= p.oh
                    assert p.ncs * p.cg >= p.groups
                    assert p.items == shape[0] * p.ncs * p.nxs * p.nys


def test_tma_entry_takes_the_plan_in_order():
    """The wrapper passes ``TmaPlan.ENTRY_FIELDS`` after the generic entry's
    arguments: ppst_upfirdn2d_tma in csrc/upfirdn2d.cu names its parameters
    alike, and the limits it checks are the wrapper's constants."""
    src = (fir._nvcc.PKG / "csrc" / "upfirdn2d.cu").read_text()
    sig = re.search(r"int ppst_upfirdn2d_tma\(([^)]*)\)", src).group(1)
    names = [a.split()[-1].lstrip("*") for a in sig.split(",")]
    generic = re.search(r"int ppst_upfirdn2d\(([^)]*)\)", src).group(1)
    assert names == [a.split()[-1].lstrip("*") for a in generic.split(",")][:-1] + [
        *fir.TmaPlan.ENTRY_FIELDS, "stream"]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kConsumers"]), int(consts["kStages"]), int(consts["kMaxBox"]),
            int(consts["kMaxSmem"]), int(consts["kMaxTaps"])) == (
        fir.TMA_CONSUMERS, fir.RING_STAGES, fir.MAX_BOX, fir.MAX_SMEM, fir.MAX_TAPS)


def test_c_entry_gets_the_plan(monkeypatch):
    """``c_entry`` hands the C entry of each route its arguments: the TMA
    entry gets the generic entry's and then the plan's ENTRY_FIELDS."""

    class Lib:
        def ppst_upfirdn2d(self, *args):
            return "generic", args

        def ppst_upfirdn2d_tma(self, *args):
            return "tma", args

    monkeypatch.setattr(fir, "_sm_count", lambda index: 132)
    x = torch.zeros((2, 11, 37, 136), dtype=torch.bfloat16)
    out = torch.zeros((2, 11, 37, 136), dtype=torch.bfloat16)
    taps = [0.125, 0.375, 0.375, 0.125]
    calls = {}
    for route in ("generic", "tma"):
        entry, args = fir.c_entry(Lib(), x, out, taps, 1, (2, 1), route)
        name, calls[route] = entry(*args, 7)
        assert name == route
    plan = fir.tma_plan(tuple(x.shape), 2, 4, 1, (2, 1), 132)
    assert calls["generic"][2:9] == (1, 2, 11, 37, 136, 11, 37)
    assert calls["generic"][10:] == (4, 2, 1, 7)
    assert calls["tma"][:9] == calls["generic"][:9] and calls["tma"][10:13] == (4, 2, 1)
    assert calls["tma"][13:] == (*(getattr(plan, f) for f in plan.ENTRY_FIELDS), 7)
