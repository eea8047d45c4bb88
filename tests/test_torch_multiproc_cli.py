"""``python -m ppst_tpu_torch.train`` as a world of two gloo ranks on the CPU,
launched by ``torch.distributed.run`` and by the JAX package's
``PPST_NUM_PROCESSES``/``PPST_COORDINATOR``/``PPST_PROCESS_ID``
(``ppst_tpu_torch.tools.multiproc_cli_smoke``), at crop 64 with narrow
widths for 4 steps of a global batch of 4: D, G, D + R1, G."""

import os
import sys

import pytest

from ppst_tpu_torch.tools import multiproc_cli_smoke as smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
LOSS_KEYS = {"D_real", "D_rec", "D_mix", "D_total", "G_L1", "G_L1_cyc", "G_GAN_rec", "G_GAN_mix",
             "G_styleContmix", "G_styleContrec", "Mask_warp", "image_warp_reg", "L1_dist"}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    return smoke.run(STEPS, 64, str(tmp_path_factory.mktemp("mpcli")))


def test_both_launches_train(launched):
    assert launched["ok"], "\n".join(launched["tails"])


def test_the_two_launches_log_the_same_losses(launched):
    """Each logged step (every step: --print_freq is the global batch) the
    same in both launches: the D losses from the first, every loss from the
    first G step on, D_R1 from the second D step on (--R1_once_every 2)."""
    worst, failures = smoke.compare(launched["logs"], STEPS)
    assert not failures, failures
    rows = launched["logs"]["torchrun"]
    assert [it for it, _ in rows] == [smoke.BATCH * i for i in range(STEPS)]
    assert {k for k in LOSS_KEYS if k.startswith("D_")} == set(rows[0][1])
    assert all(LOSS_KEYS <= set(losses) for _, losses in rows[1:])
    assert ["D_R1" in losses for _, losses in rows] == [False, False, True, True]


def test_only_rank_0_writes(launched):
    """Each rank ran in a folder of its own with a relative
    --checkpoints_dir: rank 1 wrote nothing, rank 0 the options, the
    background and the last checkpoints, the iteration count and the log."""
    rank0, rank1 = launched["files"]
    assert rank1 == []
    run = os.path.join("checkpoints", "smoke")
    assert {os.path.join(run, f) for f in ("opt.txt", "opt.pkl", "0k_checkpoint.pth",
                                           "latest_checkpoint.pth", "iter.txt",
                                           "loss_log.txt")} <= set(rank0)


def test_log_is_parsed_as_jax_parses_it(launched, tmp_path):
    """``parse_log`` reads a log as ``tools/multihost_cli_smoke._parse_log``
    does."""
    sys.path.insert(0, ROOT)
    from tools.multihost_cli_smoke import _parse_log

    path = tmp_path / "loss_log.txt"
    rows = launched["logs"]["torchrun"]
    path.write_text("================ Training Loss ================\n" + "".join(
        f"(iters: {it}, data: 0.1ms/img) " + "".join(f"{k}: {v:.3f} " for k, v in losses.items())
        + "\n" for it, losses in rows))
    assert smoke.parse_log(str(path)) == _parse_log(str(path)) == rows
