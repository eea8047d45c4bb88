"""K1's and K2's tiling, emulated on the CPU: the persistent kernels of
``csrc/tap.cu`` and ``csrc/tap_bwd.cu`` (see ``csrc/tap_common.cuh``) walk a
static schedule of 128-pixel items (64 rows for each of two consumer
warpgroups), keep per-(sample, block) records of
partial statistics that the next pass sums in block order, feed the 1x1
products from registers in the ``wgmma`` A-fragment layout, and recompute
du, dp2 and dn2 in pass C instead of storing dn2. This file emulates that
arithmetic in torch (float32, bf16 where the kernels round) and holds it to
the plain versions within ``chip_smoke.py``'s tolerances, and at one small
shape to ``ppst_tpu``'s Pallas kernels in interpret mode.

The kernels themselves run only on the card (``chip_smoke.py`` and
``ppst_tpu_torch/tools/tap_ab.py`` hold them against the same plain
versions); this file checks that the schedule, the record layout, the
fragment indexing, the swizzled reads and the fixed-order reductions compute
the tap and its gradients, and that the tolerances have margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops import tap_pallas
from ppst_tpu_torch.ops import tap_cuda

# chip_smoke.py's tolerances of K1 and K2 against their plain versions
TAP_MAX_ABS, TAP_MEAN_ABS, TAP_BWD_REL = 0.06, 5e-3, 0.02
NAMES = ("dx", "dw1", "db1", "da1", "dw2", "db2", "da2")
# (B, H, W, 128): a ragged last item in every sample (960 = 7.5 x 128), a
# single sample whose 720 pixels end in the second warpgroup's half of an
# item, and a square two-sample shape
SHAPES = [(3, 40, 24, 128), (1, 20, 36, 128), (2, 64, 64, 128)]
IDS = ["3x40x24", "1x20x36", "2x64x64"]
P, HALF, GROUP = 128, 64, 8  # pixels an item, a warpgroup's rows; blocks a group
SMS = 5  # an emulated card of 5 SMs: 5 blocks, each straddling samples


class Sched:
    """tap_common.cuh's static schedule: T items a sample, G blocks walking
    contiguous item ranges."""

    def __init__(self, batch, n, blocks):
        self.T = -(-n // P)
        self.total = batch * self.T
        self.G = min(blocks, self.total)

    def lo(self, g):
        return g * self.total // self.G

    def block_of(self, i):
        return ((i + 1) * self.G - 1) // self.total

    def first_block(self, b):
        return self.block_of(b * self.T)

    def last_block(self, b):
        return self.block_of(b * self.T + self.T - 1)


def _bf(v):
    return v.to(torch.bfloat16).float()


def _prelu(v, a):
    return v.clamp_min(0.0) + a * v.clamp_max(0.0)


# -- the layouts ---------------------------------------------------------------


def _kernel_pairs():
    """The kernels' bf16 pair p of thread (wg, w, lane) (tap_common.cuh's
    frag_row): row 64 wg + 16 w + g + 8 (p % 2) of the item, channels
    8 (p // 2) + 2 q, + 1 (g = lane / 4, q = lane % 4); arrays of shape
    (2, 4, 32, 32) for a 128-wide operand."""
    wg, w, lane, p = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(32),
                                 indexing="ij")
    g, q = lane // 4, lane % 4
    return 64 * wg + 16 * w + g + 8 * (p % 2), 8 * (p // 2) + 2 * q


def _ptx_a_fragment():
    """The PTX ISA's A fragment of wgmma .m64nNk16 (bf16, A in registers),
    register r of k-step kk of thread (w, lane) of the warpgroup that owns
    rows 64 wg ..: rows 16 w + g (r = 0, 2) or + 8 (r = 1, 3), columns
    16 kk + 2 q (r < 2) or + 8 (r >= 2), two each."""
    wg, w, lane, kk, r = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(8),
                                     np.arange(4), indexing="ij")
    g, q = lane // 4, lane % 4
    rows = 64 * wg + 16 * w + g + 8 * (r % 2)
    cols = 16 * kk + 2 * q + 8 * (r // 2)
    return rows.reshape(2, 4, 32, 32), cols.reshape(2, 4, 32, 32)


def _swz(row, byte):
    """tap_common.cuh's swz: byte offset in a 128B-swizzled tile."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


ROWS, COLS = _kernel_pairs()


def _a_operand(tile, scale):
    """A (128 x C: each warpgroup's 64-row operand) as the consumer threads
    build it: each thread reads its
    pairs of ``tile`` (64, C) at the kernel's (row, channel), transforms
    them with ``scale`` (values, channels) -> values, rounds to bf16, and the
    pair lands where the PTX A fragment puts register 4 kk + r."""
    c_in = tile.shape[1]
    rows_k, cols_k = ROWS[..., : c_in // 4], COLS[..., : c_in // 4]
    rows_p, cols_p = (v[..., : c_in // 4] for v in _ptx_a_fragment())
    a = torch.full_like(tile, float("nan"))
    for e in (0, 1):
        r_k, c_k = torch.from_numpy(rows_k.ravel()), torch.from_numpy(cols_k.ravel() + e)
        vals = _bf(scale(tile[r_k, c_k], c_k))
        a[torch.from_numpy(rows_p.ravel()), torch.from_numpy(cols_p.ravel() + e)] = vals
    assert not torch.isnan(a).any()  # every element of A written once
    return a


def test_fragment_indexing_matches_ptx():
    """The kernels' pair p = 4 kk + r is the PTX A fragment's register r of
    k-step kk (so a pair read at (row, channel) is normalized with that
    channel's statistics), and an accumulator's pairs are the same
    positions: an accumulator rounded to bf16 pairs is an A operand."""
    rows_p, cols_p = _ptx_a_fragment()
    assert np.array_equal(ROWS, rows_p) and np.array_equal(COLS, cols_p)
    # accumulator element 4 j + 2 h + e: row 16 w + g + 8 h, column 8 j + 2 q + e
    wg, w, lane, j, h = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(16),
                                    np.arange(2), indexing="ij")
    acc_rows = (64 * wg + 16 * w + lane // 4 + 8 * h).reshape(2, 4, 32, 32)
    acc_cols = (8 * j + 2 * (lane % 4)).reshape(2, 4, 32, 32)
    assert np.array_equal(ROWS, acc_rows) and np.array_equal(COLS, acc_cols)
    # every (row, channel pair) of a 128 x 128 tile once
    cells = set(zip(ROWS.ravel().tolist(), COLS.ravel().tolist()))
    assert len(cells) == 128 * 64


def test_swizzled_reads_hit_every_bank_once():
    """A warp's 4-byte pair loads of one pair index p, and its 16-byte chunk
    loads of the statistics passes, from a 128B-swizzled tile touch 32
    distinct banks per 128 bytes: no bank conflicts."""
    for wg in range(2):
        for w in range(4):
            for p in range(16):
                offs = [_swz(int(ROWS[wg, w, lane, p]), 2 * int(COLS[wg, w, lane, p]) % 128)
                        for lane in range(32)]
                assert len({o // 4 % 32 for o in offs}) == 32
    # the apply's reads: lane t reads chunk t % 8 of row t / 8 (+ 32 k)
    for base in range(0, 128, 32):
        offs = [_swz((base + lane) // 8, 16 * ((base + lane) % 8)) for lane in range(8)]
        assert len({o // 16 % 8 for o in offs}) == 8
    # swz permutes the 16-byte chunks within each row
    for row in range(P):
        assert sorted(_swz(row, 16 * c) for c in range(8)) == [row * 128 + 16 * c
                                                                for c in range(8)]


def test_quad_transpose():
    """The epilogues' two xor exchanges (tap_common.cuh::quad_transpose),
    step by step: word c of lane q becomes word q of lane c."""
    w = [[(q, c) for c in range(4)] for q in range(4)]
    for k in range(2):  # lanes q ^ 2: the high half of one word pair
        send = [w[q][k] if q & 2 else w[q][2 + k] for q in range(4)]
        for q in range(4):
            w[q][k if q & 2 else 2 + k] = send[q ^ 2]
    for k in range(2):  # lanes q ^ 1
        send = [w[q][2 * k] if q & 1 else w[q][2 * k + 1] for q in range(4)]
        for q in range(4):
            w[q][2 * k if q & 1 else 2 * k + 1] = send[q ^ 1]
    assert w == [[(c, q) for c in range(4)] for q in range(4)]


def _running_sum_of_squares(v, per_item_and_compensated):
    """A statistics-pass thread's float32 running sum of v**2 over one
    sample's 2048 items split among 8 blocks (16 threads a channel, 8 rows an
    item each, as at (16, 512, 512, 128) on 132 SMs); then the threads' sums
    and the blocks' records in order."""
    items = v.reshape(2048, 8, 16)  # (item, row of the thread, thread)
    total = np.float32(0)
    for blk in np.array_split(np.arange(2048), 8):
        s, c = np.zeros(16, np.float32), np.zeros(16, np.float32)
        for it in blk:
            sq = (items[it] * items[it]).astype(np.float32)
            if per_item_and_compensated:  # tap.cu: the item's rows, then kahan_add
                part = np.zeros(16, np.float32)
                for r in range(8):
                    part = (part + sq[r]).astype(np.float32)
                y = (part - c).astype(np.float32)
                t = (s + y).astype(np.float32)
                c = ((t - s).astype(np.float32) - y).astype(np.float32)
                s = t
            else:
                for r in range(8):
                    s = (s + sq[r]).astype(np.float32)
        block = np.float32(0)
        for x in (s - c).astype(np.float32):
            block = np.float32(block + x)
        total = np.float32(total + block)
    return total


def test_running_sums_of_bf16_squares_do_not_drift():
    """Why K1's statistics sum each item's rows first and keep compensated
    running sums: a plain float32 running sum of bf16 squares over ~2000
    rows a thread drifts by about -4e-6 (measured on an H100: x's rstd off
    by 2e-6 at (16, 512, 512, 128), which flipped 0.5% of t), the kernel's
    order stays at float32 noise."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(2048 * 128).astype(
        np.float32)).bfloat16().float().numpy()
    exact = float((v.astype(np.float64) ** 2).sum())
    plain = abs(float(_running_sum_of_squares(v, False)) - exact) / exact
    kernel = abs(float(_running_sum_of_squares(v, True)) - exact) / exact
    assert plain > 1e-6, plain
    assert kernel < 3e-7, kernel


@pytest.mark.parametrize("batch,n,blocks", [(1, 720, 5), (3, 960, 5), (2, 4096, 132),
                                            (16, 262144, 132), (5, 64, 6), (7, 129, 3)])
def test_schedule_and_records(batch, n, blocks):
    """Every item in one block's contiguous range, blocks in order;
    block_of inverts lo; the records b + g of the (sample, block) pairs that
    meet are distinct and fit B + G - 1."""
    sc = Sched(batch, n, blocks)
    owner = [None] * sc.total
    for g in range(sc.G):
        assert sc.lo(g + 1) > sc.lo(g)
        for i in range(sc.lo(g), sc.lo(g + 1)):
            owner[i] = g
    assert all(o is not None for o in owner)
    sample = np.random.default_rng(0).integers(0, sc.total, 2000)
    assert all(sc.block_of(int(i)) == owner[int(i)] for i in sample)
    records = set()
    for g in range(sc.G):
        for b in range(sc.lo(g) // sc.T, (sc.lo(g + 1) - 1) // sc.T + 1):
            assert b + g not in records
            records.add(b + g)
            assert sc.first_block(b) <= g <= sc.last_block(b)
    assert max(records) < batch + sc.G - 1


# -- the emulated kernels ------------------------------------------------------


class Records:
    """A pass's (B + G - 1, 2, C) records: each written once, by block g for
    sample b at b + g; sample b's are summed over its blocks in order."""

    def __init__(self, sc, batch, c):
        self.sc = sc
        self.rec = torch.full((batch + sc.G - 1, 2, c), float("nan"))

    def write(self, b, g, sums, squares):
        assert torch.isnan(self.rec[b + g]).all()
        self.rec[b + g, 0], self.rec[b + g, 1] = sums, squares

    def sums(self, b):
        acc = torch.zeros_like(self.rec[0])
        for g in range(self.sc.first_block(b), self.sc.last_block(b) + 1):
            assert not torch.isnan(self.rec[b + g]).any()
            acc = acc + self.rec[b + g]
        return acc


def _items(sc, n):
    """Each block's items in order: (g, i, b, p0, valid rows, whether it is
    the block's last item of sample b, when the block writes b's record)."""
    for g in range(sc.G):
        last = sc.lo(g + 1) - 1
        for i in range(sc.lo(g), last + 1):
            b, p0 = i // sc.T, (i % sc.T) * P
            yield g, i, b, p0, min(P, n - p0), i == last or (i + 1) // sc.T != b


def _tile(v, b, p0, valid):
    """An item's tile of v (B, n, C) as TMA writes it: rows past n zero."""
    out = torch.zeros((P, v.shape[-1]))
    out[:valid] = v[b, p0 : p0 + valid].float()
    return out


def _moments(records, b, n):
    s = records.sums(b)
    mean = s[0] / n
    var = (s[1] / n - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + 1e-5)


def _stats_pass(inp, sc, n):
    """K1's pass 1: per-(block, sample) sums of inp's values into records."""
    rec, run = Records(sc, inp.shape[0], inp.shape[-1]), 0.0
    for g, _, b, p0, valid, ends in _items(sc, n):
        v = _tile(inp, b, p0, valid)  # the zero rows add nothing
        run = run + torch.stack([v.sum(0), (v * v).sum(0)])
        if ends:
            rec.write(b, g, *run)
            run = 0.0
    return rec


def _conv_pass(inp, rec_in, sc, n, weight, bias, slope):
    """K1's conv passes: out = bf16(A @ W^T + bias) with A built from the
    normalized (and PReLU'd) input by the threads' fragment pairs; the
    statistics of out's rounded values into records; the input's mean and
    rstd (B, 2, C) as the first block of each sample writes them."""
    out = torch.zeros(inp.shape[:2] + (64,), dtype=torch.bfloat16)
    rec, run, mr = Records(sc, inp.shape[0], 64), 0.0, {}
    for g, _, b, p0, valid, ends in _items(sc, n):
        if b not in mr:
            mr[b] = _moments(rec_in, b, n)
        m, r = mr[b]

        def norm(v, ch, m=m, r=r):
            y = (v - m[ch]) * r[ch]
            return y if slope is None else _prelu(y, slope)

        v = _bf(_a_operand(_tile(inp, b, p0, valid), norm) @ _bf(weight).t() + bias)[:valid]
        out[b, p0 : p0 + valid] = v.to(torch.bfloat16)
        run = run + torch.stack([v.sum(0), (v * v).sum(0)])
        if ends:
            rec.write(b, g, *run)
            run = 0.0
    return out, rec, torch.cat([torch.stack(mr[b]).reshape(-1) for b in range(inp.shape[0])])


def emulate_forward(x, w1, b1, a1, w2, b2, a2):
    """K1's four passes: (out, t, u, mr)."""
    bsz, h, w, c = x.shape
    n = h * w
    sc = Sched(bsz, n, SMS)
    xs = x.reshape(bsz, n, c)
    rec1 = _stats_pass(xs, sc, n)
    t, rec2, mr1 = _conv_pass(xs, rec1, sc, n, w1, b1, None)
    u, rec3, mr2 = _conv_pass(t, rec2, sc, n, w2, b2, float(a1))
    out, mr3 = torch.zeros_like(u), []
    for b in range(bsz):  # the apply: every block of sample b has the same moments
        m, r = _moments(rec3, b, n)
        mr3.append(torch.stack([m, r]).reshape(-1))
        out[b] = _prelu((u[b].float() - m) * r, float(a2)).to(torch.bfloat16)
    mr = torch.cat([mr1, mr2, torch.cat(mr3)])
    shape = (bsz, h, w, 64)
    return out.reshape(shape), t.reshape(shape), u.reshape(shape), mr


def _hi_lo(v):
    hi = _bf(v)
    return hi, _bf(v - hi)


def _split_mr(mr, bsz):
    m1, r1, m2, r2, m3, r3 = tap_cuda.split_stats(mr, bsz)
    return [v.reshape(bsz, -1) for v in (m1, r1, m2, r2, m3, r3)]


def _ordered_sum(parts):
    acc = torch.zeros_like(parts[0])
    for v in parts:
        acc = acc + v
    return acc


def emulate_backward(x, t, u, mr, w1, w2, a1, a2, g_out, need_dx=True):
    """K2's passes A, B, C (and D): (dx or None, dw1, db1, da1, dw2, db2, da2)."""
    bsz, h, w, cin = x.shape
    n = h * w
    sab = scd = Sched(bsz, n, SMS)
    xs, ts, us, gs = (v.reshape(bsz, n, -1) for v in (x, t, u, g_out))
    m1, r1, m2, r2, m3, r3 = _split_mr(mr, bsz)
    a1, a2 = float(a1), float(a2)
    w1b, w2b = _bf(w1), _bf(w2)

    def items(sc):
        for g, i, b, p0, valid, _ in _items(sc, n):
            yield g, i, b, p0, valid

    tile = _tile

    def records_of(sc, per_item, c):
        """Records from per-item (sum, square) rows, summed per (block,
        sample) in item order."""
        rec, run = Records(sc, bsz, c), 0.0
        for g, i, b, _, _, ends in _items(sc, n):
            run = run + torch.stack(per_item[i])
            if ends:
                rec.write(b, g, *run)
                run = 0.0
        return rec

    # pass A
    per_item, pda = {}, [0.0] * sab.G
    for g, i, b, p0, valid in items(sab):
        uu, gg = tile(us, b, p0, valid), tile(gs, b, p0, valid)
        n3 = (uu - m3[b]) * r3[b]
        d = gg * torch.where(n3 > 0, 1.0, a2)
        per_item[i] = (d.sum(0), (d * n3).sum(0))
        pda[g] = pda[g] + float((gg * n3.clamp_max(0.0)).sum())
    recA = records_of(sab, per_item, 64)
    s3 = {b: recA.sums(b) / n for b in range(bsz)}

    def chain_dp2(b, p0, valid):
        """du (hi, lo), dp2 and dn2, n2 of one item: passes B, C and D's code."""
        uu, gg, tt = (tile(v, b, p0, valid) for v in (us, gs, ts))
        ok = (torch.arange(P) < valid)[:, None]
        n3 = (uu - m3[b]) * r3[b]
        dn3 = gg * torch.where(n3 > 0, 1.0, a2)
        du = torch.where(ok, r3[b] * ((dn3 - s3[b][0]) - n3 * s3[b][1]), 0.0)
        hi, lo = _hi_lo(du)
        dp2 = hi @ w2b + lo @ w2b  # du W2: (p, o) x (o, i)
        n2 = (tt - m2[b]) * r2[b]
        dn2 = dp2 * torch.where(n2 > 0, 1.0, a1)
        return du, hi, lo, dp2, n2, dn2, ok

    # pass B
    dn2_b, per_item = {}, {}
    # one partial a consumer warpgroup: 2 g + wg over its 64 rows of each item
    pB = [torch.zeros(64 * 64 + 64 + 1) for _ in range(2 * sab.G)]
    for g, i, b, p0, valid in items(sab):
        du, hi, lo, dp2, n2, dn2, _ = chain_dp2(b, p0, valid)
        dn2_b[i] = dn2
        p2 = _bf(_prelu(n2, a1))
        for wg in (0, 1):
            rows = slice(HALF * wg, HALF * wg + HALF)
            dw2 = hi[rows].t() @ p2[rows] + lo[rows].t() @ p2[rows]
            pB[2 * g + wg] = pB[2 * g + wg] + torch.cat(
                [dw2.reshape(-1), du[rows].sum(0),
                 (dp2[rows] * n2[rows].clamp_max(0.0)).sum().reshape(1)])
        per_item[i] = (dn2.sum(0), (dn2 * n2).sum(0))
    recB = records_of(sab, per_item, 64)
    s2 = {b: recB.sums(b) / n for b in range(bsz)}
    # pass C's slices: 8 threads an element over every 8th partial, then in order
    stacked = torch.stack(pB)
    slices = [stacked[s::8].sum(0) if len(stacked[s::8]) else torch.zeros_like(stacked[0])
              for s in range(8)]
    b_out = _ordered_sum(slices)
    dw2 = b_out[: 64 * 64].reshape(64, 64)
    db2, da1 = b_out[64 * 64 : 64 * 64 + 64], b_out[-1:]
    da2 = torch.tensor([sum(pda)])

    # pass C (and with dx the sums of dn1)
    pC = [torch.zeros(64 * 128 + 64) for _ in range(2 * scd.G)]
    per_item, dts = {}, {}
    for g, i, b, p0, valid in items(scd):
        _, _, _, dp2, n2, dn2, ok = chain_dp2(b, p0, valid)
        assert torch.equal(dn2, dn2_b[i])  # pass B's dn2 to the bit
        dt = torch.where(ok, r2[b] * ((dn2 - s2[b][0]) - n2 * s2[b][1]), 0.0)
        hi, lo = _hi_lo(dt)
        dts[i] = (hi, lo)
        n1 = (tile(xs, b, p0, valid) - m1[b]) * r1[b]
        for wg in (0, 1):
            rows = slice(HALF * wg, HALF * wg + HALF)
            n1b = _bf(n1[rows])
            dw1 = hi[rows].t() @ n1b + lo[rows].t() @ n1b
            pC[2 * g + wg] = pC[2 * g + wg] + torch.cat([dw1.reshape(-1), dt[rows].sum(0)])
        if need_dx:
            dn1 = hi @ w1b + lo @ w1b
            per_item[i] = (dn1.sum(0), (dn1 * n1).sum(0))
    # the last block of each group of 8 sums its group's partials, the last
    # group the groups
    groups = [_ordered_sum(pC[2 * k : 2 * k + 2 * GROUP]) for k in range(0, scd.G, GROUP)]
    c_out = _ordered_sum(groups)
    dw1, db1 = c_out[: 64 * 128].reshape(64, 128), c_out[64 * 128 :]

    dx = None
    if need_dx:
        recC = records_of(scd, per_item, 128)
        s1 = {b: recC.sums(b) / n for b in range(bsz)}
        dx = torch.zeros((bsz, n, cin), dtype=torch.bfloat16)
        for g, i, b, p0, valid in items(scd):
            _, _, _, _, _, dn2, _ = chain_dp2(b, p0, valid)
            assert torch.equal(dn2, dn2_b[i])
            hi, lo = dts[i]
            dn1 = hi @ w1b + lo @ w1b
            n1 = (tile(xs, b, p0, valid) - m1[b]) * r1[b]
            o = r1[b] * ((dn1 - s1[b][0]) - n1 * s1[b][1])
            dx[b, p0 : p0 + valid] = o[:valid].to(torch.bfloat16)
        dx = dx.reshape(x.shape)
    return dx, dw1, db1, da1, dw2, db2, da2


# -- against the plain versions and ppst_tpu ------------------------------------


def _inputs(rng, shape):
    b, h, w, cin = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    w1 = torch.from_numpy((rng.standard_normal((64, cin)) * 0.1).astype(np.float32))
    b1 = torch.from_numpy((rng.standard_normal((64,)) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((64, 64)) * 0.1).astype(np.float32))
    b2 = torch.from_numpy((rng.standard_normal((64,)) * 0.1).astype(np.float32))
    a1, a2 = torch.tensor([0.25]), torch.tensor([-0.1])
    g = torch.from_numpy(rng.standard_normal((b, h, w, 64)).astype(np.float32)).bfloat16()
    return (x, w1, b1, a1, w2, b2, a2), g


def _assert_forward_close(got, want):
    err = (got.float() - want.float()).abs()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert err.max().item() <= TAP_MAX_ABS, err.max().item()
    assert err.mean().item() <= TAP_MEAN_ABS, err.mean().item()


def _assert_grads_close(got, want):
    """chip_smoke.py's rule: every gradient within TAP_BWD_REL of its max; the
    bias gradients (a mathematical zero) at noise level."""
    overall = max(v.abs().max().item() for v in want if v is not None)
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = a.float().reshape(b.shape), b.float()
        assert torch.isfinite(a).all(), name
        bmax = b.abs().max().item()
        if name.startswith("db"):
            assert bmax < 0.02 * overall, name
            assert a.abs().max().item() <= max(bmax, 0.01 * overall), name
        else:
            assert (a - b).abs().max().item() <= TAP_BWD_REL * bmax, (name, bmax)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_forward_matches_plain(rng, shape):
    args, _ = _inputs(rng, shape)
    out, t, u, mr = emulate_forward(*args)
    want, (t_ref, u_ref, mr_ref) = tap_cuda._forward_reference(*args)
    _assert_forward_close(out, want)
    _assert_forward_close(t, t_ref)
    _assert_forward_close(u, u_ref)
    assert torch.allclose(mr, mr_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("need_dx", [False, True], ids=["no_dx", "dx"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_backward_matches_plain(rng, shape, need_dx):
    args, g = _inputs(rng, shape)
    x, w1, _, a1, w2, _, a2 = args
    _, (t, u, mr) = tap_cuda._forward_reference(*args)
    got = emulate_backward(x, t, u, mr, w1, w2, a1, a2, g, need_dx)
    want = tap_cuda.fused_tap_1x1_bwd_reference(x, t, u, mr, w1, w2, a1, a2, g, need_dx)
    _assert_grads_close(got, want)


def test_emulated_tap_matches_pallas(rng):
    """At (2, 32, 32, 128) (16 items on 5 blocks, two of which straddle the
    samples): the emulated forward against tap_pallas.fused_tap_1x1 in
    interpret mode, and the emulated backward on JAX's residuals against
    its Pallas backward."""
    args, g = _inputs(rng, (2, 32, 32, 128))
    x, w1, b1, a1, w2, b2, a2 = args
    jargs = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w1.numpy().T),
             jnp.asarray(b1.numpy()), jnp.float32(a1.item()), jnp.asarray(w2.numpy().T),
             jnp.asarray(b2.numpy()), jnp.float32(a2.item()))
    want = tap_pallas.fused_tap_1x1(*jargs, interpret=True)
    got = emulate_forward(*args)[0]
    _assert_forward_close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))

    _, res = tap_pallas._fused_tap_impl(True, *jargs)
    gj = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    jgrads = tap_pallas._fused_tap_bwd(True, res, gj)
    dx, dw1, db1, da1, dw2, db2, da2 = (torch.from_numpy(np.array(v, np.float32))
                                        for v in jgrads)
    want = (dx, dw1.t(), db1, da1.reshape(1), dw2.t(), db2, da2.reshape(1))
    xr, tr, ur, m1, r1, m2, r2, m3, r3 = (torch.from_numpy(np.array(v.astype(jnp.float32)))
                                          for v in res[:9])
    mr = torch.cat([torch.stack([m[:, 0, 0], r[:, 0, 0]], 1).reshape(-1)
                    for m, r in ((m1.reshape(2, 1, 1, -1), r1.reshape(2, 1, 1, -1)),
                                 (m2.reshape(2, 1, 1, -1), r2.reshape(2, 1, 1, -1)),
                                 (m3.reshape(2, 1, 1, -1), r3.reshape(2, 1, 1, -1)))])
    got = emulate_backward(xr.bfloat16(), tr.bfloat16(), ur.bfloat16(), mr, w1, w2, a1, a2, g)
    _assert_grads_close(got, want)


# -- the wrapper's checks --------------------------------------------------------


def _cpu_args():
    e = torch.empty
    x = e((2, 4, 4, 128), dtype=torch.bfloat16)
    return x, e(64, 128), e(64), e(1), e(64, 64), e(64), e(1)


def test_check_inputs_accepts_the_kernels_arguments():
    x, w1, b1, a1, w2, b2, a2 = _cpu_args()
    tap_cuda.check_inputs(x, w1, b1, a1, w2, b2, a2, device_type="cpu")
    t = torch.empty((2, 4, 4, 64), dtype=torch.bfloat16)
    tap_cuda.check_inputs(x, w1, None, a1, w2, None, a2, t=t, u=t, g=t,
                          mr=torch.empty(2 * 512), device_type="cpu")


@pytest.mark.parametrize("case", ["device", "dtype", "channels", "w1", "batch", "stride", "bias",
                                  "slope", "t", "mr"])
def test_check_inputs_refuses(case):
    x, w1, b1, a1, w2, b2, a2 = _cpu_args()
    kw = {}
    t = torch.empty((2, 4, 4, 64), dtype=torch.bfloat16)
    device_type = "cpu"
    if case == "device":
        device_type = "cuda"
    elif case == "dtype":
        x = x.float()
    elif case == "channels":
        x = torch.empty((2, 4, 4, 64), dtype=torch.bfloat16)
    elif case == "w1":
        w1 = torch.empty(128, 64)
    elif case == "batch":
        x = torch.empty((0, 4, 4, 128), dtype=torch.bfloat16)
    elif case == "stride":
        x = torch.empty((2, 4, 8, 128), dtype=torch.bfloat16)[:, :, ::2]
    elif case == "bias":
        b1 = torch.empty(32)
    elif case == "slope":
        a1 = torch.empty(2)
    elif case == "t":
        kw = dict(t=t.float(), u=t, g=t, mr=torch.empty(2 * 512))
    elif case == "mr":
        kw = dict(t=t, u=t, g=t, mr=torch.empty(2 * 511))
    with pytest.raises(ValueError):
        tap_cuda.check_inputs(x, w1, b1, a1, w2, b2, a2, device_type=device_type, **kw)
