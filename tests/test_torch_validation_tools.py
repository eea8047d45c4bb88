"""The port's training-validation tools (``ppst_tpu_torch/tools/``) on the
CPU at NARROW: the synthetic stream against the JAX tools' draws, the two
driving schedules against the JAX tools' loops, each tool's ``run`` for a
few steps, its JSON against the keys of the JAX tool's recorded file, and
each entry point's refusal to run without a card unless given ``--device
cpu``."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_train_common import NARROW

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.tools import bf16_validation, loss_curve_parity, lpips_ablation, stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WIDTHS = {k: v for k, v in NARROW.items() if k != "crop_size"}


def _jax_tool(name):
    """A JAX package tool (``tools/<name>.py``) as a module."""
    import importlib

    return importlib.import_module(f"tools.{name}")


def _keys(path):
    with open(os.path.join(ROOT, path)) as f:
        data = json.load(f)
    return set(data), {k for v in data["summary"].values() for k in v}


@pytest.mark.parametrize("crop", [64, 256])
def test_stream_draws_jax_tools_batches(monkeypatch, crop):
    """The same images and masks, byte for byte, as
    ``tools/loss_curve_parity.make_batch`` draws from one seed (the order of
    ``tools/bf16_validation.py:52-60`` too)."""
    jax_lcp = _jax_tool("loss_curve_parity")
    monkeypatch.setattr(jax_lcp, "CROP", crop)
    mine, theirs = np.random.default_rng(21), np.random.default_rng(21)
    for _ in range(3):
        got, want = stream.make_batch(mine, 2, crop), jax_lcp.make_batch(theirs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (2, crop, crop, 3)
            assert g.tobytes() == w.tobytes()


def test_summaries_are_jax_tools():
    """``tail_mean`` and ``ema_series`` give what the JAX tools' do."""
    rng = np.random.default_rng(0)
    rows = [{"a": float(x), **({"b": float(x) * 2} if i % 3 == 0 else {})}
            for i, x in enumerate(rng.standard_normal(37))]
    jax_abl, jax_lcp = _jax_tool("lpips_ablation"), _jax_tool("loss_curve_parity")
    for key in ("a", "b", "c"):
        assert stream.tail_mean(rows, key) == jax_abl.tail_mean(rows, key)
        np.testing.assert_array_equal(stream.ema_series(rows, key),
                                      jax_lcp.ema_series(rows, key))


class _Recorder:
    """TrainSteps' surface, recording which step ran."""

    def __init__(self, r1_every):
        self.model = torch.nn.Module()
        for net in stream.NETS:
            setattr(self.model, net, torch.nn.Linear(1, 1))
        self.model.device = torch.device("cpu")
        self.cfg = self.model.cfg = PPSTConfig(R1_once_every=r1_every)
        self.opts, self.calls = {}, []

    def _step(self, kind):
        def step(real, mask, gen):
            self.calls.append(kind)
            return {f"{kind}_loss": torch.zeros(())}
        return step

    def __getattr__(self, name):
        if name in ("d_step", "d_step_r1", "g_step"):
            return self._step(name)
        raise AttributeError(name)


def test_paired_schedule_is_bf16_validations():
    """Each iteration a D step (with R1 at i % R1_once_every == 0) and a G
    step: ``tools/bf16_validation.py:61-67``."""
    rec = _Recorder(4)
    rows = stream.drive(rec, 9, 2, 16, 0, "paired", log_every=0).rows
    want = []
    for i in range(9):
        want += ["d_step_r1" if i % 4 == 0 else "d_step", "g_step"]
    assert rec.calls == want and len(rows) == 9


def test_alternate_schedule_is_loss_curve_paritys(monkeypatch):
    """One step a batch through ``PPSTOptimizer``: D on even steps with R1
    at every R1_once_every-th D step, G on odd ones
    (``tools/loss_curve_parity.py:186-207``)."""
    rec = _Recorder(3)
    monkeypatch.setattr(stream, "PPSTOptimizer", _optimizer_over(rec))
    rows = stream.drive(rec, 14, 2, 16, 0, "alternate", log_every=0).rows
    want, n_d = [], 0
    for step in range(14):
        if step % 2 == 0:
            n_d += 1
            want.append("d_step_r1" if n_d % 3 == 0 else "d_step")
        else:
            want.append("g_step")
    assert rec.calls == want
    assert [r["step"] for r in rows] == list(range(14))


def _optimizer_over(rec):
    from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer

    class Optimizer(PPSTOptimizer):
        def __init__(self, opt, bundle):
            super().__init__(opt, bundle)
            self.steps = rec
    return Optimizer


@pytest.fixture(scope="module")
def bf16_runs():
    return [bf16_validation.run(dtype, 3, 64, 2, bf16_validation.SEED, "cpu", **WIDTHS)
            for dtype in ("float32", "bfloat16")]


def test_bf16_validation_runs_both_arms(bf16_runs):
    """Both arms finite, every network moved, R1 in the first iteration
    only, the float32 arm's first D step as a float32 TrainSteps takes it."""
    t32, t16 = bf16_runs
    for t in bf16_runs:
        assert len(t.rows) == 3 and stream.finite(t.rows)
        assert all(v > 0 for v in t.moved.values()), t.moved
        assert [("D_R1" in r) for r in t.rows] == [True, False, False]
        assert t.peak_mem_gib is None
    model = PPSTModel(PPSTConfig(crop_size=64, **WIDTHS), device="cpu", seed=0)
    from ppst_tpu_torch.train.steps import TrainSteps

    real, mask = (torch.from_numpy(v)
                  for v in stream.make_batch(np.random.default_rng(bf16_validation.SEED), 2, 64))
    first = TrainSteps(model).d_step_r1(real, mask, torch.Generator().manual_seed(0))
    for k, v in first.items():
        assert t32.rows[0][k] == pytest.approx(v.item(), rel=1e-6), k


def test_bf16_validation_json_has_jax_keys(bf16_runs, tmp_path):
    """curves.json holds the JAX tool's keys (``results/bf16_validation``)
    and three more; its summary the JAX tool's per-loss keys; every G-side
    loss the summary holds."""
    t32, t16 = bf16_runs
    data = bf16_validation.report(t32, t16, 64, 2, "cpu", {})
    top, per_loss = _keys("results/bf16_validation/curves.json")
    assert set(data) == top | {"device", "bf16_config", "peak_mem_gib"}
    assert all(set(v) == per_loss for v in data["summary"].values())
    assert set(bf16_validation.G_SIDE) <= set(data["summary"])
    json.dumps(data)


def test_lpips_ablation_arms(tmp_path):
    """Arm A (lambda_Cycwarp 5) carries image_warp_reg, arm B has none; the
    JSON holds the JAX tool's keys (``results/lpips_ablation``) and
    ``device``."""
    a, b = (lpips_ablation.run(lam, 2, 64, 2, lpips_ablation.SEED, "cpu", **WIDTHS)
            for lam in (5.0, 0.0))
    assert stream.finite(a.rows) and stream.finite(b.rows)
    assert all(r["image_warp_reg"] > 0 for r in a.rows)
    assert not any("image_warp_reg" in r for r in b.rows)
    data = lpips_ablation.report(a, b, 2, 64, 2, "cpu")
    top, per_loss = _keys("results/lpips_ablation/ablation.json")
    assert set(data) == top | {"device"}
    assert set(data["summary"]) == set(lpips_ablation.KEYS)
    assert all(set(v) == per_loss for v in data["summary"].values())
    assert data["summary"]["image_warp_reg"]["cycwarp0"] is None


def test_loss_curve_parity_from_a_checkpoint(tmp_path):
    """The stage-1 run from a saved state dict is the run from the same
    weights drawn anew; ``--compare`` of the rows with themselves gives
    zero gaps."""
    cfg = dict(crop_size=64, **loss_curve_parity.STAGE1, **WIDTHS)
    torch.save(PPSTModel(PPSTConfig(**cfg), device="cpu", seed=0).state_dict(),
               tmp_path / "w.pth")
    kw = dict(steps=4, seed=11, crop=64, batch=2, device="cpu", R1_once_every=2, **WIDTHS)
    loaded = loss_curve_parity.run(init=str(tmp_path / "w.pth"), **kw).rows
    drawn = loss_curve_parity.run(**kw).rows
    assert loaded == drawn
    assert [r["step"] for r in loaded] == [0, 1, 2, 3] and "D_R1" in loaded[2]
    assert not any(k.startswith("G_styleCont") or k == "image_warp_reg"
                   for r in loaded for k in r)
    (tmp_path / "a.json").write_text(json.dumps(loaded))
    summary = loss_curve_parity.compare(loaded, loaded)
    assert {"D_real", "D_rec", "G_L1", "G_GAN_rec", "D_R1"} == set(summary)
    assert all(v["max_abs_ema_gap"] == 0 for v in summary.values())
    assert loss_curve_parity.main(["--compare", str(tmp_path / "a.json"),
                                   str(tmp_path / "a.json")]) == 0


@pytest.mark.parametrize("tool", [bf16_validation, lpips_ablation, loss_curve_parity])
def test_entry_point_needs_a_card_or_device_cpu(tool, monkeypatch, tmp_path):
    """Without CUDA and without --device cpu each tool raises before it
    trains or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
