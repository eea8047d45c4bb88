"""Weight bridge: ``ppst_tpu`` parameter trees -> this package's state_dict.

Takes the JAX package's ``{"E1", "E2", "G", "D"}`` param trees as nested
dicts of numpy arrays and returns the ``state_dict`` of ``PPSTModel`` (the
reference PyTorch key names). It is the inverse of
``ppst_tpu/util/convert_torch.py``: conv kernels (kh, kw, I, O) ->
(O, I, kh, kw), linears (I, O) -> (O, I). ``lpips_from_flax`` and
``rscl_from_flax`` carry the LPIPS weights and the RSCL state the same way,
and ``adam_from_flax`` an optax Adam state (its moments have the weights'
tree, so they take the weights' transposes). Leaves may be numpy arrays or
(bfloat16 leaves of ``util.msgpack_ckpt``) torch tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class _Tree(dict):
    """A network's flax tree whose missing keys read as empty subtrees, so
    that the bridge carries every leaf that is there and leaves out the
    others (the loader's merge reports them)."""

    def __getitem__(self, key):
        v = self.get(key, {})
        return _Tree(v) if isinstance(v, dict) else v


def _np(x):
    """A leaf as a numpy array (a bfloat16 tensor as float32); None for a
    missing leaf (an empty subtree, or None)."""
    if x is None or isinstance(x, dict):
        return None
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _transpose(w, axes):
    """A present leaf of len(axes) dims transposed; any other as it is."""
    w = _np(w)
    return np.transpose(w, axes) if w is not None and w.ndim == len(axes) else w


def _cw(w):  # conv kernel
    return _transpose(w, (3, 2, 0, 1))


def _lw(w):  # linear weight
    return _transpose(w, (1, 0))


def _as_nchw(w):  # a per-channel bias as (1, C, 1, 1)
    w = _np(w)
    return None if w is None else w.reshape(1, -1, 1, 1)


class _Out:
    """Prefix-scoped writer into a flat state dict."""

    def __init__(self, sd: Dict, prefix: str = ""):
        self.sd, self.prefix = sd, prefix

    def __setitem__(self, key, value):
        value = _np(value)
        if value is not None:
            self.sd[self.prefix + key] = torch.from_numpy(np.array(value, np.float32))

    def sub(self, prefix: str) -> "_Out":
        return _Out(self.sd, self.prefix + prefix)


def _conv_layer(out: _Out, p):
    out["Conv.weight"] = _cw(p["conv"]["weight"])
    if "bias" in p["conv"]:
        out["Conv.bias"] = p["conv"]["bias"]
    if "act_bias" in p:
        out["Act.bias"] = p["act_bias"]


def _res_block(out: _Out, p):
    for name in ("conv1", "conv2", "skip"):
        _conv_layer(out.sub(f"{name}."), p[name])


def _linear(out: _Out, p, transpose=_lw):
    out["weight"] = transpose(p["weight"])
    out["bias"] = p["bias"]


def _epilogue(out: _Out, p):
    _linear(out.sub("epi1.style_mod.lin."), p["epi1"]["style_mod"]["lin"])


def _styled_conv(out: _Out, p):
    out["conv.weight"] = _cw(p["conv"]["weight"])
    out["conv.bias"] = p["conv"]["bias"]
    if "noise" in p:
        out["noise.weight"] = p["noise"]["weight"]
    out["bias"] = _as_nchw(p["bias"])
    out["activate.bias"] = p["act_bias"]
    _epilogue(out, p)


def _torch_conv(out: _Out, p):
    _linear(out, p, transpose=_cw)


def _residual_block(out: _Out, p):
    _torch_conv(out.sub("conv1."), p["conv1"])
    _torch_conv(out.sub("conv2."), p["conv2"])
    out["prelu.weight"] = p["prelu"]["alpha"]


def from_e1(out: _Out, p):
    _conv_layer(out.sub("FromRGB."), p["from_rgb"])
    i = 0
    while f"down{2 ** i}" in p:
        _res_block(out.sub(f"DownToSpatialCode.ResBlockDownBy{2 ** i}."), p[f"down{2 ** i}"])
        i += 1
    _conv_layer(out.sub("ToSpatialCode.0."), p["to_sp0"])
    _conv_layer(out.sub("ToSpatialCode.1."), p["to_sp1"])


def _projection_head(out: _Out, p, key: str):
    w = _lw(p["reduce"]["weight"])
    out[f"conv1x1_{key}.weight"] = None if w is None else w[:, :, None, None]
    out[f"conv1x1_{key}.bias"] = p["reduce"]["bias"]
    for idx, name in (("1", "fc0"), ("3", "fc1"), ("5", "fc2")):
        _linear(out.sub(f"projector{key}.{idx}."), p[name])


def from_e2(out: _Out, p):
    _conv_layer(out.sub("FromRGB."), p["from_rgb"])
    _projection_head(out, p["head_in"], "9")
    i = 0
    while f"down{2 ** i}" in p:
        _res_block(out.sub(f"DownToGlobalCode1.ResBlockDownBy{2 ** i}."), p[f"down{2 ** i}"])
        _projection_head(out, p[f"head{i}"], str(i))
        i += 1


def from_g(out: _Out, p):
    for name in ("scale", "bias"):
        _linear(out.sub(f"SpatialCodeModulation.{name}."), p["sp_mod"][name])
    for flax_name, ref_name in [(k, f"HeadResnetBlock{k[4:]}") for k in p
                                if k.startswith("head")] + [
            (k, f"UpsamplingResBlock{k[2:]}") for k in p if k.startswith("up")]:
        blk, o = p[flax_name], out.sub(f"{ref_name}.")
        _styled_conv(o.sub("conv1."), blk["conv1"])
        _styled_conv(o.sub("conv2."), blk["conv2"])
        if "skip" in blk:
            _conv_layer(o.sub("skip."), blk["skip"])
    rgb = p["to_rgb"]
    out["ToRGB.conv.weight"] = _cw(rgb["conv"]["weight"])
    out["ToRGB.conv.bias"] = rgb["conv"]["bias"]
    out["ToRGB.bias"] = _as_nchw(rgb["bias"])
    _epilogue(out.sub("ToRGB."), rgb)
    for key in (k[3:] for k in p if k.startswith("tap")):
        tap, o = p[f"tap{key}"], out.sub(f"layer{key}.")
        _torch_conv(o.sub("2."), tap["conv1"])
        o["4.weight"] = tap["prelu1"]["alpha"]
        _torch_conv(o.sub("6."), tap["conv2"])
        o["8.weight"] = tap["prelu2"]["alpha"]
    for i in range(3):
        _residual_block(out.sub(f"layert.{i}."), p[f"fuse{i}"])
    _residual_block(out.sub("layert1.0."), p["fuse1_res"])
    _torch_conv(out.sub("layert1.1."), p["fuse1_conv"])


def from_d(out: _Out, p):
    """Inverse of convert_torch.convert_d: the ResBlock at 2^i is
    ``convs.<9 - i>`` (``convs.<s>x<s>`` above 256)."""
    core, o = p["core"], out.sub("stylegan2_D.")
    _conv_layer(o.sub("convs.0."), core["from_rgb"])
    for key in (k for k in core if k.startswith("res")):
        i = int(key[3:]).bit_length() - 1
        _res_block(o.sub(f"convs.{9 - i if i <= 8 else key[3:] + 'x' + key[3:]}."), core[key])
    _conv_layer(o.sub("final_conv."), core["final_conv"])
    _linear(o.sub("final_linear.0."), core["fc0"])
    _linear(o.sub("final_linear.1."), core["fc1"])


NETS = {"E1": from_e1, "E2": from_e2, "G": from_g, "D": from_d}


def net_from_flax(net: str, tree: Dict) -> Dict[str, torch.Tensor]:
    """One network's flax tree (``net`` in E1, E2, G, D) -> its entries of
    the ``PPSTModel`` state_dict. A leaf missing from ``tree`` is left out."""
    sd: Dict[str, torch.Tensor] = {}
    NETS[net](_Out(sd, f"{net}."), _Tree(tree))
    return sd


def from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """``{"E1", "E2", "G"[, "D"]}`` flax param trees -> ``PPSTModel``
    state_dict (D's keys only when the tree has D)."""
    sd: Dict[str, torch.Tensor] = {}
    for net in NETS:
        if net != "D" or "D" in params:
            sd.update(net_from_flax(net, params[net]))
    return sd


def adam_from_flax(opt_state: Dict, net: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """One network's optax ``adam`` state, ``{"0": {count, mu, nu}, "1": {}}``
    (``scale_by_adam``, then the learning rate's empty state), -> the torch
    Adam state of each of its parameters, by state_dict key: ``step`` =
    count (the two bias corrections agree), ``exp_avg`` / ``exp_avg_sq`` =
    mu / nu carried as the weights are."""
    adam = opt_state["0"]
    mu, nu = net_from_flax(net, adam["mu"]), net_from_flax(net, adam["nu"])
    step = float(_np(adam["count"]))
    return {k: {"step": torch.tensor(step), "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}


def lpips_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """ppst_tpu.ops.lpips variables -> ``ops.lpips.LPIPS`` state_dict."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    out = _Out(sd)
    for i, tv in enumerate((0, 3, 6, 8, 10)):
        conv = p["net"][f"conv{i}"]
        out[f"net.slice{i + 1}.{tv}.weight"] = _cw(conv["kernel"])
        out[f"net.slice{i + 1}.{tv}.bias"] = conv["bias"]
        out[f"lin{i}.model.1.weight"] = _np(p[f"lin{i}"]).reshape(1, -1, 1, 1)
    return sd


def rscl_from_flax(state: Dict) -> Dict[str, torch.Tensor]:
    """ppst_tpu's training state -> the RSCL state ``PPSTModel.
    set_rscl_state`` takes."""
    rscl = state["rscl"]
    return {"queues": torch.from_numpy(np.array(_np(rscl["queues"]), np.float32)),
            "ptrs": torch.from_numpy(np.array(_np(rscl["ptrs"]), np.int64))}
