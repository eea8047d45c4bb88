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

``create_model`` loads ``<checkpoints_dir>/<name>/<resume_iter>`` at test
time, and raises ``FileNotFoundError`` where it is missing, as the JAX
package's does (``ppst_tpu/train/bundle.py:323-337``); the test CLI's
``--checkpoint FILE`` loads that file instead. At train time it loads only
under ``--continue_train``, and starts from the seed's weights where the
file is missing.

``load`` also reads the JAX package's checkpoints
(``<N>k_checkpoint.msgpack``, ``latest_checkpoint.msgpack``) through
``util.msgpack_ckpt`` and the weight bridge: weights, RSCL state, D-step
count and the optax Adam states. Where both kinds exist it takes the
``.pth``.

``save(steps, blocking=False)`` keeps the training loop going while a
checkpoint is written (the JAX package's ``save(blocking=False)``,
``ppst_tpu/train/bundle.py:104-147``): the training thread only clones the
payload (weights, RSCL state, every Adam's moments and step counts, which
the next ``opt.step()`` changes in place) into fresh buffers on the device;
a writer thread copies them to the host on a stream of its own, writes the
file and then moves ``latest_checkpoint.pth``. One save is in flight at a
time; a writer's error is raised at the next ``save`` or
``join_pending_save``. The clones hold the checkpoint's size of device
memory until the writer has copied them to the host.

Under ``torch.distributed`` (``parallel``) every rank builds the model from
the same seed, and rank 0's parameters, buffers and RSCL queues are
broadcast after the build and after a load; only rank 0 writes checkpoints.
Rank 0 draws the training noise from ``--seed`` as a single process does;
rank ``r`` from a stream of its own.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.train.steps import make_optimizers
from ppst_tpu_torch.util.from_flax import NETS, adam_from_flax, net_from_flax, rscl_from_flax
from ppst_tpu_torch.util.msgpack_ckpt import read_checkpoint
from ppst_tpu_torch.util.spans import span


class ModelBundle:
    def __init__(self, opt, cfg: PPSTConfig = None):
        self.opt = opt
        self.cfg = cfg or PPSTConfig.from_options(opt)
        self.device = resolve_device(getattr(opt, "device", None))
        seed = getattr(opt, "seed", 0)
        self.model = PPSTModel(self.cfg, device=self.device, seed=seed)
        parallel.broadcast_module(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(
            noise_seed(seed, parallel.rank()))
        # serving builds none: torch's first Adam imports torch._dynamo,
        # seconds of a test CLI call
        self.optimizers = make_optimizers(self.model) if getattr(opt, "isTrain", True) else {}
        self._save_thread = self._save_error = None
        for key in ("E1", "E2", "G", "D"):
            net = getattr(self.model, key)
            n = sum(p.numel() for p in net.parameters())
            print(f"Network [{type(net).__name__}] was created. Total number of "
                  f"parameters: {n / 1e6:.1f} million.")

    @property
    def save_dir(self) -> str:
        return os.path.join(self.opt.checkpoints_dir, self.opt.name)

    def _payload(self, steps: int) -> dict:
        """What a checkpoint holds, as references to the live tensors."""
        return {
            "state_dict": self.model.state_dict(),
            "rscl": self.model.rscl_state(),
            "num_d_iters": self.model.num_d_iters,
            "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
            "steps": steps,
        }

    def save(self, steps: int, blocking: bool = True):
        """Write ``<steps // 1000>k_checkpoint.pth`` (rank 0 only), on this
        thread or, with ``blocking=False``, on a writer thread from clones of
        the payload (see the module's docstring). While a profiler runs, the
        loop's stall here (a pending save's join, the snapshot and, with
        ``blocking``, the write) is the span ``ppst.ckpt:save``; the writer
        thread's copy and write are not recorded (a plain thread does not see
        the profiler)."""
        with span("ckpt:save"):
            self.join_pending_save()
            if not parallel.is_primary():
                return
            t0 = time.perf_counter()
            if blocking:
                path = self._write(_map_tensors(self._payload(steps), lambda t: t.cpu()), steps)
                print(f"Saved checkpoint at {path} in {(time.perf_counter() - t0) * 1e3:.1f} ms")
                return
            snap = _map_tensors(self._payload(steps), lambda t: t.detach().clone())
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
            # handed over in a box, so that the writer holds the only reference
            # and frees the clones once they are on the host
            self._save_thread = threading.Thread(target=self._write_in_background,
                                                 args=([snap], ready, steps), name="ppst-ckpt",
                                                 daemon=True)
            del snap
            self._save_thread.start()
            print(f"Checkpoint of image {steps}: {(time.perf_counter() - t0) * 1e3:.1f} ms on the "
                  "training thread, written in the background")

    def _write_in_background(self, box, ready, steps):
        try:
            t0 = time.perf_counter()
            snap = box.pop()
            if ready is not None:
                stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    host = _map_tensors(snap, lambda t: t.to("cpu", non_blocking=True))
                stream.synchronize()  # before the clones go back to the allocator
                snap = host
            path = self._write(snap, steps)
            print(f"Saved checkpoint at {path} in the background in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        except Exception as e:  # raised by join_pending_save
            self._save_error = e

    def join_pending_save(self):
        """Wait for the save in flight, and raise its writer's error."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("the background checkpoint save failed") from err

    def _write(self, payload: dict, steps: int) -> str:
        """Write ``payload`` atomically (a temporary file, then ``os.replace``),
        then point ``latest_checkpoint.pth`` at it."""
        os.makedirs(self.save_dir, exist_ok=True)
        name = f"{steps // 1000}k_checkpoint.pth"
        path = os.path.join(self.save_dir, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        latest = os.path.join(self.save_dir, "latest_checkpoint.pth")
        os.symlink(name, latest + ".tmp")
        os.replace(latest + ".tmp", latest)
        return path

    def load(self, resume_iter: str = "latest", pretrained_name: str = None):
        """Tolerant load: a key missing from the file or of another shape
        keeps its initialization, with a warning; at test time D and the
        optimizers' state are skipped (the reference skips D,
        base_model.py:61)."""
        load_dir = (os.path.join(self.opt.checkpoints_dir, pretrained_name) if pretrained_name
                    else self.save_dir)
        stem = ("latest_checkpoint" if resume_iter == "latest"
                else f"{resume_iter.replace('k', '')}k_checkpoint")
        path = os.path.join(load_dir, stem + ".pth")
        if os.path.exists(path):
            raw = torch.load(path, map_location=self.device, weights_only=True)
        elif os.path.exists(os.path.join(load_dir, stem + ".msgpack")):
            path = os.path.join(load_dir, stem + ".msgpack")
            raw = self._from_jax(read_checkpoint(path))
        else:
            raise FileNotFoundError(f"no {stem}.pth or {stem}.msgpack in {load_dir}")
        sd = raw.get("state_dict", raw)
        serving = not getattr(self.opt, "isTrain", True)
        own = self.model.state_dict()
        merged = {}
        for k, v in own.items():
            new = sd.get(k)
            if serving and k.startswith("D."):
                merged[k] = v
            elif new is None:
                print(f"[load] missing {k}, keeping initialization")
                merged[k] = v
            elif _squeezed(new.shape) != _squeezed(v.shape):
                print(f"[load] shape mismatch at {k}: {tuple(v.shape)} vs {tuple(new.shape)}, "
                      "keeping initialization")
                merged[k] = v
            else:
                merged[k] = new.reshape(v.shape)
        self.model.load_state_dict(merged)
        if "rscl" in raw:
            self.model.set_rscl_state({k: v.to(self.device) for k, v in raw["rscl"].items()})
        self.model.num_d_iters = int(raw.get("num_d_iters", 0))
        for k, state in ({} if serving else raw.get("optimizers", {})).items():
            try:
                self.optimizers[k].load_state_dict(state)
            except (KeyError, ValueError) as e:
                print(f"[load] could not restore the {k} optimizer ({e}); restarting moments")
        parallel.broadcast_module(self.model)
        print(f"Loaded checkpoint from {path}")

    def _from_jax(self, tree) -> dict:
        """A JAX package checkpoint's tree in the layout of this package's
        ``.pth``: the weights through the bridge (which leaves out a leaf the
        tree lacks, for ``load``'s merge to report), the RSCL state, the D-step count and the
        four optimizers' state dicts."""
        params = tree.get("params", {})
        sd = {}
        for net in NETS:
            if net in params:
                sd.update(net_from_flax(net, params[net]))
        raw = {"state_dict": sd}
        state = tree.get("state", {})
        if "rscl" in state:
            raw["rscl"] = rscl_from_flax(state)
        if "num_d_iters" in state:
            raw["num_d_iters"] = int(state["num_d_iters"])
        if "opt_states" in tree and self.optimizers:
            try:
                raw["optimizers"] = {k: self._adam_state_dict(k, tree["opt_states"][k])
                                     for k in self.optimizers}
                print("[load] optimizer state restored")
            except (KeyError, ValueError, TypeError) as e:  # structure drift
                print(f"[load] could not restore optimizer state ({e!r}); restarting moments")
        return raw

    def _adam_state_dict(self, net: str, opt_state) -> dict:
        """optax's Adam state of ``net`` as the state dict of its torch Adam,
        matched by parameter name, never by position."""
        by_key = adam_from_flax(opt_state, net)
        state = {}
        for i, (name, p) in enumerate(getattr(self.model, net).named_parameters()):
            st = by_key[f"{net}.{name}"]
            if _squeezed(st["exp_avg"].shape) != _squeezed(p.shape):
                raise ValueError(f"{net}.{name}: moments of shape {tuple(st['exp_avg'].shape)} "
                                 f"for a parameter of shape {tuple(p.shape)}")
            state[i] = {"step": st["step"], "exp_avg": st["exp_avg"].reshape(p.shape),
                        "exp_avg_sq": st["exp_avg_sq"].reshape(p.shape)}
        return {"state": state,
                "param_groups": self.optimizers[net].state_dict()["param_groups"]}


def noise_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s training noise: ``seed`` itself on rank 0
    (a single process's stream), a stream of its own on every other rank."""
    return seed if rank == 0 else seed * 1000003 + rank


def _map_tensors(tree, fn):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _squeezed(shape) -> tuple:
    """A shape without its unit dims: the reference stores some biases as
    (1, C, 1, 1), and JAX some scalars as ()."""
    return tuple(n for n in shape if n != 1)


def create_model(opt) -> ModelBundle:
    bundle = ModelBundle(opt)
    is_train = getattr(opt, "isTrain", True)
    if not is_train and getattr(opt, "checkpoint", None):
        bundle.model.load_reference_checkpoint(opt.checkpoint)
        print(f"Loaded checkpoint from {opt.checkpoint}")
    elif not is_train or getattr(opt, "continue_train", False):
        try:
            bundle.load(getattr(opt, "resume_iter", "latest"),
                        getattr(opt, "pretrained_name", None))
        except FileNotFoundError as e:
            if not is_train:
                raise
            print(f"[load] {e}; starting from scratch")
    return bundle
