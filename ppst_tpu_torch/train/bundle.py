"""ModelBundle: the model, its optimizers, the noise generator and the
checkpoints (counterpart of ``ppst_tpu/train/bundle.py``; reference
models/base_model.py:33-112).

Checkpoints keep the reference's naming: ``<steps // 1000>k_checkpoint.pth``
and ``latest_checkpoint.pth`` (a symlink to it) under
``<checkpoints_dir>/<name>/``. A checkpoint holds the model's ``state_dict``
under the reference's keys (``E1.``, ``E2.``, ``G.``, ``D.``), so the
reference's loaders, ``ppst_tpu.util.convert_torch`` and
``python -m ppst_tpu_torch.test --checkpoint`` read it, plus the RSCL state,
the D-step count, the four optimizers' state (the reference restarts Adam's
moments on resume; this does not) and the image count. Writes are atomic: a
temporary file, then ``os.replace``.
"""

from __future__ import annotations

import os

import torch

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.train.steps import make_optimizers


class ModelBundle:
    def __init__(self, opt, cfg: PPSTConfig = None):
        self.opt = opt
        self.cfg = cfg or PPSTConfig.from_options(opt)
        self.device = resolve_device(getattr(opt, "device", None))
        seed = getattr(opt, "seed", 0)
        self.model = PPSTModel(self.cfg, device=self.device, seed=seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizers = make_optimizers(self.model)
        for key in ("E1", "E2", "G", "D"):
            net = getattr(self.model, key)
            n = sum(p.numel() for p in net.parameters())
            print(f"Network [{type(net).__name__}] was created. Total number of "
                  f"parameters: {n / 1e6:.1f} million.")

    @property
    def save_dir(self) -> str:
        return os.path.join(self.opt.checkpoints_dir, self.opt.name)

    def save(self, steps: int):
        os.makedirs(self.save_dir, exist_ok=True)
        name = f"{steps // 1000}k_checkpoint.pth"
        path = os.path.join(self.save_dir, name)
        payload = {
            "state_dict": self.model.state_dict(),
            "rscl": self.model.rscl_state(),
            "num_d_iters": self.model.num_d_iters,
            "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
            "steps": steps,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        latest = os.path.join(self.save_dir, "latest_checkpoint.pth")
        os.symlink(name, latest + ".tmp")
        os.replace(latest + ".tmp", latest)
        print(f"Saved checkpoint at {path}")

    def load(self, resume_iter: str = "latest", pretrained_name: str = None):
        """Tolerant load: a key missing from the file or of another shape
        keeps its initialization, with a warning; at test time D is
        skipped, as in the reference (base_model.py:61)."""
        load_dir = (os.path.join(self.opt.checkpoints_dir, pretrained_name) if pretrained_name
                    else self.save_dir)
        name = ("latest_checkpoint.pth" if resume_iter == "latest"
                else f"{resume_iter.replace('k', '')}k_checkpoint.pth")
        path = os.path.join(load_dir, name)
        raw = torch.load(path, map_location=self.device, weights_only=True)
        sd = raw.get("state_dict", raw)
        skip_d = not getattr(self.opt, "isTrain", True)
        own = self.model.state_dict()
        merged = {}
        for k, v in own.items():
            new = sd.get(k)
            if (skip_d and k.startswith("D.")) or new is None:
                if not skip_d:
                    print(f"[load] missing {k}, keeping initialization")
                merged[k] = v
            elif new.numel() != v.numel():
                print(f"[load] shape mismatch at {k}: {tuple(v.shape)} vs {tuple(new.shape)}, "
                      "keeping initialization")
                merged[k] = v
            else:
                merged[k] = new.reshape(v.shape)
        self.model.load_state_dict(merged)
        if "rscl" in raw:
            self.model.set_rscl_state({k: v.to(self.device) for k, v in raw["rscl"].items()})
        self.model.num_d_iters = int(raw.get("num_d_iters", 0))
        for k, state in raw.get("optimizers", {}).items():
            try:
                self.optimizers[k].load_state_dict(state)
            except (KeyError, ValueError) as e:
                print(f"[load] could not restore the {k} optimizer ({e}); restarting moments")
        print(f"Loaded checkpoint from {path}")


def create_model(opt) -> ModelBundle:
    bundle = ModelBundle(opt)
    if getattr(opt, "continue_train", False):
        try:
            bundle.load(getattr(opt, "resume_iter", "latest"),
                        getattr(opt, "pretrained_name", None))
        except FileNotFoundError as e:
            print(f"[load] {e}; starting from scratch")
    return bundle
