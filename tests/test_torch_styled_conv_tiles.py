"""K6's tiling, emulated on the CPU: the haloed input windows of
``csrc/styled_conv.cu`` (forward and dx) and ``csrc/styled_conv_bwd.cu``
(dW) as the kernels' tensor maps write them into shared memory, read back the
way the ``wgmma`` descriptors read them, summed in the kernels' order, held
against the plain versions within ``chip_smoke.py``'s tolerances.

The kernels themselves run only on the card (``chip_smoke.py`` and
``ppst_tpu_torch/tools/k6_ab.py`` hold them against the same plain
versions); this file checks on the CPU that the window arithmetic (the tensor
maps' dimensions and strides, the taps' start offsets, LBO and SBO) computes
the 3x3 conv and its weight gradient, and that the tolerances have margin.
The weight and dpre tiles are 128B-swizzled on the card; the swizzle is the
tensor map's and the descriptor's business and is not emulated here.
"""

import math

import numpy as np
import pytest
import torch

from ppst_tpu_torch.ops import styled_conv_cuda as sc

# chip_smoke.py's tolerances of K6 against its plain version
K6_MAX, K6_MEAN, K6_BWD_REL = 0.02, 1e-4, 0.01
# (B, H, W, Cin, Cout): W not a multiple of the 64-pixel segment, Cin not a
# multiple of the 64-channel chunk; and a generator-like shape
SHAPES = [(1, 20, 36, 48, 80), (2, 3, 70, 32, 16), (2, 64, 64, 64, 128)]
IDS = ["1x20x36x48to80", "2x3x70x32to16", "2x64x64x64to128"]
# the kernels' tiling: tiles of 4 rows x one 64-pixel segment, 64-channel
# chunks of x, 128 output channels (csrc/styled_conv.cu, styled_conv_bwd.cu)
ROWS, SEG, CHUNK, BN = 4, 64, 64, 128
WIN_COLS = SEG + 2


def _tma_box(x, coords, box):
    """What a bf16 tensor map over NHWC ``x`` (B, H, W, C) with dimensions
    (8, W, H, C / 8, B) and byte strides (-, 2C, 2WC, 16, 2HWC) writes into
    shared memory for boxes at ``coords`` (T, 5), box dimensions ``box``:
    (T, prod(box)) elements, dimension 0 fastest, zeros outside the tensor."""
    b, h, w, c = x.shape
    dims = torch.tensor([8, w, h, c // 8, b])
    strides = torch.tensor([1, c, w * c, 8, h * w * c])  # in elements
    axes = torch.meshgrid(*[torch.arange(n) for n in reversed(box)], indexing="ij")
    rel = torch.stack([a.reshape(-1) for a in reversed(axes)], -1)  # (prod(box), 5), dim 0 fastest
    pos = coords[:, None, :] + rel[None]  # (T, E, 5)
    ok = ((pos >= 0) & (pos < dims)).all(-1)
    flat = x.reshape(-1)
    idx = (pos.clamp_min(0) * strides).sum(-1).clamp_max(flat.numel() - 1)
    return torch.where(ok, flat[idx], torch.zeros((), dtype=x.dtype))


def _operand(win, start, lbo, sbo, rows, k_major):
    """A wgmma operand of ``rows`` x 16 (M or N by K) read from flat windows
    ``win`` (T, E) with no swizzle: core matrices of 8 x 16 bytes, LBO between
    neighbours along K, SBO between neighbours along M or N. K-major: row r,
    element k at (k / 8) LBO + (r / 8) SBO + (r % 8) 16 + (k % 8) 2 bytes;
    MN-major: (r / 8) SBO + (r % 8) 2 + (k / 8) LBO + (k % 8) 16."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    if k_major:
        byte = start + (k // 8) * lbo + (r // 8) * sbo + (r % 8) * 16 + (k % 8) * 2
    else:
        byte = start + (r // 8) * sbo + (r % 8) * 2 + (k // 8) * lbo + (k % 8) * 16
    return win[:, (byte // 2).reshape(-1)].reshape(win.shape[0], rows, 16)


def _conv_tiles(x, wt9):
    """The conv core: per tile (4 rows x 64 columns, all output channels at
    once) and 64-channel chunk, the window TMA writes ([channel group][row]
    [column][8 channels]); each row segment's A read at the tap's start
    offset, K-major, LBO = one channel group, SBO = 128 bytes; float32 sums
    over (chunk, tap, k16 step) in the kernel's order. Returns the tiles'
    float32 sums (T, 4 segments, 64, N) and their (b, tile row, tile col)."""
    b, h, w, k = x.shape
    n = wt9.shape[1]
    th, tw = math.ceil(h / ROWS), math.ceil(w / SEG)
    tiles = torch.tensor([(bi, r, c) for bi in range(b) for r in range(th) for c in range(tw)])
    group = (ROWS + 2) * WIN_COLS * 16
    acc = torch.zeros((len(tiles), ROWS, SEG, n))
    wpad = torch.zeros((9, n, math.ceil(k / CHUNK) * CHUNK), dtype=wt9.dtype)
    wpad[:, :, :k] = wt9
    for ch in range(math.ceil(k / CHUNK)):
        coords = torch.stack([torch.zeros(len(tiles), dtype=torch.long), tiles[:, 2] * SEG - 1,
                              tiles[:, 1] * ROWS - 1, torch.full((len(tiles),), ch * CHUNK // 8),
                              tiles[:, 0]], -1)
        win = _tma_box(x, coords, (8, WIN_COLS, ROWS + 2, CHUNK // 8, 1))
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for kk in range(4):
                wb = wpad[tap, :, ch * CHUNK + 16 * kk:ch * CHUNK + 16 * kk + 16].float().T
                for s in range(ROWS):
                    start = 2 * kk * group + ((s + dy) * WIN_COLS + dx) * 16
                    a = _operand(win, start, group, 128, SEG, k_major=True).float()
                    acc[:, s] += a @ wb
    return acc, tiles


def _scatter(vals, tiles, shape):
    """Tile values (T, 4, 64, N) into (B, H, W, N), dropping what lies past
    the image, and the mask of the tiles' pixels inside it (T, 4, 64)."""
    b, h, w, n = shape
    out = torch.zeros((b, h, w, n), dtype=vals.dtype)
    rows = tiles[:, 1:2] * ROWS + torch.arange(ROWS)[None]  # (T, 4)
    cols = tiles[:, 2:3] * SEG + torch.arange(SEG)[None]  # (T, 64)
    ok = (rows < h)[:, :, None] & (cols < w)[:, None, :]
    bi = tiles[:, 0, None, None].expand_as(ok)
    out[bi[ok], rows[:, :, None].expand_as(ok)[ok], cols[:, None, :].expand_as(ok)[ok]] = vals[ok]
    return out, ok


def _tile_sums(v, ok):
    """A tile's per-channel sum of v (T, 4, 64, N) over its pixels inside the
    image in the kernel's order: each thread's four rows (its warpgroup's
    two segments, rows g and g + 8 of its warp's 16), a butterfly over the 8
    lane groups (xor 4, 8, 16 of the lane), then the 8 consumer warps in
    order, from 0."""
    v = torch.where(ok[..., None], v, torch.zeros(()))
    t, _, _, n = v.shape
    # (T, warpgroup, segment, warp, h, g, N): pixel 16 warp + 8 h + g of segment 2 wg + s
    v = v.reshape(t, 2, 2, 4, 2, 8, n)
    part = torch.zeros((t, 2, 4, 8, n))
    for s in range(2):
        for hh in range(2):
            part = part + v[:, :, s, :, hh]
    for o in (1, 2, 4):  # lane xor 4, 8, 16: g xor 1, 2, 4
        part = part + part[:, :, :, torch.arange(8) ^ o]
    part = part[:, :, :, 0].reshape(t, 8, n)
    total = torch.zeros((t, n))
    for i in range(8):
        total = total + part[:, i]
    return total


def _emulate_forward(x, w, noise, gain, bt, s1, shift):
    b, h, wd, _ = x.shape
    n = w.shape[0]
    acc, tiles = _conv_tiles(x, w.to(x.dtype).permute(2, 3, 0, 1).reshape(9, n, -1))
    rows = tiles[:, 1:2] * ROWS + torch.arange(ROWS)[None]
    cols = tiles[:, 2:3] * SEG + torch.arange(SEG)[None]
    nz = noise.to(x.dtype).float()[..., 0]
    pad = torch.zeros((b, ROWS * math.ceil(h / ROWS), SEG * math.ceil(wd / SEG)))
    pad[:, :h, :wd] = nz
    nzt = pad[tiles[:, 0, None, None], rows[:, :, None], cols[:, None, :]]
    pre = acc + gain.float() * nzt[..., None] + bt.float()
    a32 = torch.where(pre >= 0, pre, pre * 0.2) * math.sqrt(2.0)
    a, ok = _scatter(a32.to(x.dtype), tiles, (b, h, wd, n))
    psum, psq = _tile_sums(a32, ok), _tile_sums(a32 * a32, ok)
    # moments_kernel: tiles y, y + 32, ... in order for each of 32 lanes y,
    # then the 32 lanes in order
    per = len(tiles) // b  # tiles of an image, in (tile row, tile col) order
    psum, psq = psum.reshape(b, per, n), psq.reshape(b, per, n)
    s = torch.zeros((b, n))
    q = torch.zeros((b, n))
    for y in range(32):
        ls, lq = torch.zeros((b, n)), torch.zeros((b, n))
        for t in range(y, per, 32):
            ls, lq = ls + psum[:, t], lq + psq[:, t]
        s, q = s + ls, q + lq
    mean = s / (h * wd)
    var = (q / (h * wd) - mean * mean).clamp_min(0.0)
    rstd = 1.0 / torch.sqrt(var + 1e-5)
    out = ((a.float() - mean[:, None, None]) * rstd[:, None, None]) * s1[:, None, None] + \
        shift[:, None, None]
    return out.to(x.dtype)


def _dw_grid(b, h, w, cin, cout):
    """styled_conv_bwd.cu's dw_grid: (units, slices, steps a slice, steps)."""
    units = math.ceil(cin / 128) * math.ceil(cout / 128) * 3
    steps = b * h * math.ceil(w / SEG)
    s = min(-(-4 * 132 // units), (64 << 20) // (9 * cin * cout), steps)
    per = -(-steps // max(s, 1))
    return units, -(-steps // per), per, steps


def _emulate_dw(x, dpre):
    """dW as styled_conv_bwd.cu computes it: per (Cin tile of 128, kernel row
    dy, slice), steps of one 64-pixel row segment; the x window of that row
    (66 columns, [channel group][column][8 channels]) read transposed
    (MN-major, LBO 128 bytes between pixel groups, SBO one column group of
    66 x 16 bytes between channel groups) at dx x 16 bytes for tap (dy, dx);
    dpre (64 pixels x Cout) as B; float32 sums over the slice's steps and k16
    steps in order, then the slices in order. Returns (Cout, Cin, 3, 3)."""
    b, h, w, cin = x.shape
    cout = dpre.shape[-1]
    _, slices, per, steps = _dw_grid(b, h, w, cin, cout)
    segs = math.ceil(w / SEG)
    cpad = math.ceil(cout / BN) * BN
    dp = torch.zeros((b, h, segs * SEG, cpad), dtype=dpre.dtype)
    dp[:, :, :w, :cout] = dpre
    part = torch.zeros((slices, 9, math.ceil(cin / 128) * 128, cpad))
    for mt in range(math.ceil(cin / 128)):
        for dy in range(3):
            acc = torch.zeros((slices, 3, 128, cpad))
            for i in range(per):
                q = torch.arange(slices) * per + i
                live = q < steps
                q = q.clamp_max(steps - 1)
                cs, r, bi = q % segs, (q // segs) % h, q // (segs * h)
                coords = torch.stack([torch.zeros_like(q), cs * SEG - 1, r + dy - 1,
                                      torch.full_like(q, mt * 16), bi], -1)
                win = _tma_box(x, coords, (8, WIN_COLS, 1, 16, 1))
                cols = cs[:, None] * SEG + torch.arange(SEG)[None]
                tile = dp[bi[:, None], r[:, None], cols].float()  # (S, 64 pixels, Cout)
                tile = torch.where(live[:, None, None], tile, torch.zeros(()))
                for dx in range(3):
                    for kk in range(4):
                        bmat = tile[:, 16 * kk:16 * kk + 16]
                        for wg in range(2):
                            start = wg * 8 * WIN_COLS * 16 + (16 * kk + dx) * 16
                            a = _operand(win, start, 128, WIN_COLS * 16, 64, k_major=False)
                            acc[:, dx, 64 * wg:64 * wg + 64] += a.float() @ bmat
            part[:, 3 * dy:3 * dy + 3, 128 * mt:128 * mt + 128] = acc
    dw = torch.zeros(part.shape[1:])
    for s in range(slices):
        dw = dw + part[s]
    return dw[:, :cin, :cout].permute(2, 1, 0).reshape(cout, cin, 3, 3)


def _inputs(shape, seed=0):
    """chip_smoke.py's styled_conv_inputs, from numpy: bf16 activations and
    noise, He-scaled float32 weights, nonzero gain and biases."""
    rng = np.random.default_rng(seed)
    b, h, w, cin, cout = shape
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.standard_normal((b, h, w, cin))).bfloat16()
    wt = t(rng.standard_normal((cout, cin, 3, 3)) * (2.0 / (9 * cin)) ** 0.5)
    noise = t(rng.standard_normal((b, h, w, 1))).bfloat16()
    gain = torch.full((1,), 0.3)
    bt = t(rng.standard_normal((cout,)) * 0.1)
    s1 = t(rng.standard_normal((b, cout)) * 0.3 + 1.0).bfloat16().float()
    shift = t(rng.standard_normal((b, cout)) * 0.3)
    cot = t(rng.standard_normal((b, h, w, cout))).bfloat16()
    return (x, wt, noise, gain, bt, s1, shift), cot


def _bwd_rel(got, want, overall):
    """chip_smoke.py's measure: max |error| / max(max |grad|, 0.01 largest)."""
    gap = (got.float() - want.float()).abs().max().item()
    return gap / max(want.float().abs().max().item(), 0.01 * overall)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_tiles_match_plain_version(shape):
    """The tiled forward (windows, taps, epilogue, partial statistics in the
    kernel's order, the fixed-order moments and the apply) against
    ``styled_conv3x3_reference``, within chip_smoke.py's K6 bounds."""
    args, _ = _inputs(shape)
    got = _emulate_forward(*args)
    want = sc.styled_conv3x3_reference(*args)
    err = (got.float() - want.float()).abs()
    tol = K6_MAX * max(1.0, want.float().abs().max().item())
    print(f"forward tiles at {shape}: max {err.max().item():.3g} (bound {tol:.3g}), "
          f"mean {err.mean().item():.3g} (bound {K6_MEAN})")
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert err.max().item() <= tol
    assert err.mean().item() <= K6_MEAN


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dx_tiles_match_plain_version(shape):
    """dx is the same core on dpre with the flipped, in/out-transposed
    weights (K = Cout, N = Cin): held against the plain backward's dx."""
    args, cot = _inputs(shape, seed=1)
    x, w, noise, gain, bt, s1, shift = args
    _, (a, mean, rstd) = sc._forward_reference(*args)
    want = sc.styled_conv3x3_bwd_reference(x, w, noise, a, mean, rstd, s1, cot)
    dpre = _plain_dpre(a, mean, rstd, s1, cot)
    wt9 = w.to(x.dtype).flip(2, 3).permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])
    acc, tiles = _conv_tiles(dpre, wt9)
    dx, _ = _scatter(acc.to(x.dtype), tiles, x.shape)
    overall = max(v.abs().max().item() for v in want)
    rel = _bwd_rel(dx, want[0], overall)
    print(f"dx tiles at {shape}: {rel:.3g} of max(max |dx|, 0.01 largest) (bound {K6_BWD_REL})")
    assert rel <= K6_BWD_REL


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dw_tiles_match_plain_version(shape):
    """dW from the transposed window and the dpre tiles, slice partials
    reduced in order: held against the plain backward's float32 dW."""
    args, cot = _inputs(shape, seed=2)
    x, w, noise, gain, bt, s1, shift = args
    _, (a, mean, rstd) = sc._forward_reference(*args)
    want = sc.styled_conv3x3_bwd_reference(x, w, noise, a, mean, rstd, s1, cot, need_dx=False)
    got = _emulate_dw(x, _plain_dpre(a, mean, rstd, s1, cot))
    overall = max(v.abs().max().item() for v in want[1:])
    rel = _bwd_rel(got, want[1], overall)
    print(f"dW tiles at {shape}: {rel:.3g} of max(max |dW|, 0.01 largest) (bound {K6_BWD_REL})")
    assert got.dtype == torch.float32 and got.shape == want[1].shape
    assert rel <= K6_BWD_REL


def _plain_dpre(a, mean, rstd, s1, g):
    """Passes 1-2 of the backward (unchanged by the tiling): dpre in bf16,
    as styled_conv3x3_bwd_reference computes it."""
    count = a.shape[1] * a.shape[2]
    m, r, s = (v.float()[:, None, None, :] for v in (mean, rstd, s1))
    a32, g32 = a.float(), g.float()
    n = (a32 - m) * r
    dn = g32 * s
    s1m = dn.sum((1, 2), keepdim=True) / count
    s2m = (dn * n).sum((1, 2), keepdim=True) / count
    return (r * (dn - s1m - n * s2m) * math.sqrt(2.0) * torch.where(a32 >= 0, 1.0, 0.2)).to(a.dtype)


def test_tma_box_reads_the_window_layout():
    """The emulated tensor map writes [channel group][row][column][8
    channels] with zeros outside the image: a window at the top-left corner
    of a (1, 3, 5, 16) image."""
    x = torch.arange(3 * 5 * 16, dtype=torch.float32).reshape(1, 3, 5, 16).bfloat16()
    win = _tma_box(x, torch.tensor([[0, -1, -1, 0, 0]]), (8, 7, 5, 2, 1))[0]
    win = win.reshape(2, 5, 7, 8)  # group, row, column, channel
    assert torch.equal(win[:, 0], torch.zeros_like(win[:, 0]))  # row -1
    assert torch.equal(win[:, :, 0], torch.zeros_like(win[:, :, 0]))  # column -1
    assert torch.equal(win[:, 4], torch.zeros_like(win[:, 4]))  # row 3 = H
    assert torch.equal(win[:, :, 6], torch.zeros_like(win[:, :, 6]))  # column 5 = W
    for gi in range(2):
        assert torch.equal(win[gi, 1:4, 1:6], x[0, :, :, 8 * gi:8 * gi + 8])


@pytest.mark.parametrize("x_shape,w_shape,noise_shape,backward,match", [
    ((1, 8, 8, 24), (16, 24, 3, 3), (1, 8, 8, 1), False, "multiples of 16"),   # Cin % 16
    ((1, 8, 8, 16), (40, 16, 3, 3), (1, 8, 8, 1), False, "multiples of 16"),   # Cout % 16
    ((1, 8, 8, 16), (2064, 16, 3, 3), (1, 8, 8, 1), False, "Cout <= 2048"),    # Cout > 2048
    ((1, 8, 8, 16), (16, 32, 3, 3), (1, 8, 8, 1), False, "w \\(Cout, Cin"),    # Cin disagrees
    ((1, 8, 8, 16), (16, 16, 1, 1), (1, 8, 8, 1), False, "w \\(Cout, Cin"),    # not 3x3
    ((8, 8, 16), (16, 16, 3, 3), (8, 8, 1), False, "4-D"),                     # x not 4-D
    ((65536, 1, 1, 16), (16, 16, 3, 3), (65536, 1, 1, 1), False, "range"),     # batch
    ((1, 2**15, 2**15 + 1, 16), (16, 16, 3, 3), (1, 2**15, 2**15 + 1, 1), False, "range"),
    ((1, 2**15, 2**15, 512), (16, 512, 3, 3), (1, 2**15, 2**15, 1), False, "2\\^40|bytes"),
    ((1, 8, 8, 4096), (2048, 4096, 3, 3), (1, 8, 8, 1), True, "dW partials"),  # 9 Cin Cout
    ((1, 8, 8, 16), (16, 16, 3, 3), (1, 8, 4, 1), False, "noise must be"),
])
def test_check_shapes_refuses(x_shape, w_shape, noise_shape, backward, match):
    """Every shape the wrapper refuses before a launch; the CUDA wrappers
    run this check on every call."""
    with pytest.raises(ValueError, match=match):
        sc.check_shapes(x_shape, w_shape, noise_shape, backward=backward)


@pytest.mark.parametrize("x_shape,cout", [
    ((1, 20, 36, 48), 80), ((8, 512, 512, 128), 128), ((2, 1024, 1024, 128), 128),
    ((8, 64, 64, 512), 512), ((1, 1, 1, 16), 2048)])
def test_check_shapes_takes(x_shape, cout):
    b, h, w, cin = x_shape
    sc.check_shapes(x_shape, (cout, cin, 3, 3), (b, h, w, 1), backward=True)
