"""Weights across: reference state dicts in, JAX parameter trees converted.

The port's modules carry the reference PyTorch model's names, so a reference
``.pth`` (or the committed ``.npz`` golden state) loads into ``OCRModel`` with
``strict=True`` as it is. ``state_dict_from_jax`` converts a JAX parameter tree
(``texocr_tpu``'s flax layout, as numpy arrays) into those keys: the inverse of
``texocr_tpu.checkpoint.torch_shim.convert_torch_state_dict``. Dense kernels go
from (in, out) to (out, in), conv kernels from HWIO to OIHW, the grey patch
embed's (p * p * 1, D) kernel, ordered (py, px, c), to the (D, 1, p, p)
Conv2d weight, and the shared LayerNorm and the ``block``/``block_list``
duplicates are written at every key the reference has.

``load_jax_params`` reads the params of a JAX training run from the
``params_cache.msgpack`` that the JAX package's ``load_params_fast`` keeps in
a ``checkpoint_e*`` directory (flax's msgpack, read by ``checkpoint/msgpack.py``
without the ``msgpack`` package). The orbax (OCDBT) files beside it stay
unread: they need tensorstore.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict

import numpy as np
import torch

from texocr_tpu_torch.checkpoint import msgpack

POS_EMBED_KEY = "decoder.net.pos_embedding.embedding.weight"

#: The params-only cache the JAX package writes in a checkpoint directory.
JAX_PARAMS_CACHE = "params_cache.msgpack"


def _linear(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _norm(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _indexed(tree: dict, name: str) -> int:
    """How many ``{name}_{i}`` / ``{name}{i}`` entries ``tree`` has."""
    pat = re.compile(rf"{name}_?(\d+)$")
    return len([k for k in tree if pat.match(k)])


def _mha(out: dict, prefix: str, p: dict) -> None:
    for name in ("q", "k", "v"):
        out[f"{prefix}.{name}.weight"] = _linear(p[name]["kernel"])
    out[f"{prefix}.fc_out.0.weight"] = _linear(p["fc_out"]["kernel"])
    out[f"{prefix}.fc_out.0.bias"] = np.asarray(p["fc_out"]["bias"])


def _stack(out: dict, prefix: str, p: dict) -> None:
    cross = _indexed(p, "cross_attns") > 0
    n_layers = _indexed(p, "self_attns")
    per = 3 if cross else 2
    for j in range(n_layers * per):
        _norm(out, f"{prefix}.layers.{j}.0", p["shared_norm"])
    for layer in range(n_layers):
        base = layer * per
        _mha(out, f"{prefix}.layers.{base}.1", p[f"self_attns_{layer}"])
        if cross:
            _mha(out, f"{prefix}.layers.{base + 1}.1", p[f"cross_attns_{layer}"])
        mlp = p[f"mlps_{layer}"]
        mprefix = f"{prefix}.layers.{base + per - 1}.1"
        # GeGLU's fc_in is twice as wide as fc_out's input; dense + gelu's
        # (the reference's nn.Sequential(Linear, GELU)) as wide.
        glu = np.shape(mlp["fc_in"]["kernel"])[1] == 2 * np.shape(mlp["fc_out"]["kernel"])[0]
        fc_in = f"{mprefix}.fc_in.fc" if glu else f"{mprefix}.fc_in.0"
        out[f"{fc_in}.weight"] = _linear(mlp["fc_in"]["kernel"])
        out[f"{fc_in}.bias"] = np.asarray(mlp["fc_in"]["bias"])
        out[f"{mprefix}.fc_out.weight"] = _linear(mlp["fc_out"]["kernel"])
        out[f"{mprefix}.fc_out.bias"] = np.asarray(mlp["fc_out"]["bias"])


def _bottleneck(out: dict, prefix: str, p: dict) -> None:
    for alias in ("block_list", "block"):
        for i, (conv, norm) in enumerate((("conv1", "norm1"), ("conv2", "norm2"),
                                          ("conv3", "norm3"))):
            out[f"{prefix}.{alias}.{2 * i}.weight"] = _conv(p[conv]["kernel"])
            _norm(out, f"{prefix}.{alias}.{2 * i + 1}", p[norm])
    if "proj_conv" in p:
        out[f"{prefix}.downsample.conv.weight"] = _conv(p["proj_conv"]["kernel"])
        _norm(out, f"{prefix}.downsample.norm", p["proj_norm"])


def _hybrid(out: dict, enc: dict) -> None:
    bb = enc["backbone"]
    prefix = "encoder.patch_embed.backbone_net"
    out[f"{prefix}.stem.0.weight"] = _conv(bb["stem_conv"]["kernel"])
    _norm(out, f"{prefix}.stem.1", bb["stem_norm"])
    for s in range(_indexed(bb, "stage")):
        stage = bb[f"stage{s}"]
        for i in range(_indexed(stage, "block")):
            _bottleneck(out, f"{prefix}.stages.{s}.stage_blocks.{i}", stage[f"block{i}"])
    proj = np.asarray(enc["proj"]["kernel"])  # (in, out)
    out["encoder.patch_embed.proj.weight"] = np.ascontiguousarray(proj.T[:, :, None, None])
    out["encoder.patch_embed.proj.bias"] = np.asarray(enc["proj"]["bias"])


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``{'encoder': ..., 'decoder': ...}`` parameter tree (with or without
    the top-level ``'params'`` key) -> reference-keyed float32 tensors: the
    hybrid or the grey (one-channel) patch embed, GeGLU (``fc_in.fc``) or
    dense + gelu (``fc_in.0``) MLPs, decoder stacks with or without
    cross-attention, each as the tree holds it."""
    params = params.get("params", params)
    enc, dec = params["encoder"], params["decoder"]
    out: Dict[str, np.ndarray] = {}
    if "patch_embed" in enc:
        kernel = np.asarray(enc["patch_embed"]["kernel"])  # (p * p, D), (py, px)
        patch = math.isqrt(kernel.shape[0])
        if patch * patch != kernel.shape[0]:
            raise ValueError(f"patch embed kernel {kernel.shape} is not (p * p, D)")
        weight = kernel.reshape(patch, patch, 1, -1).transpose(3, 2, 0, 1)
        out["encoder.patch_embed.proj.weight"] = np.ascontiguousarray(weight)
        out["encoder.patch_embed.proj.bias"] = np.asarray(enc["patch_embed"]["bias"])
    else:
        _hybrid(out, enc)
    out["encoder.cls_token"] = np.asarray(enc["cls_token"])
    out["encoder.pos_embed"] = np.asarray(enc["pos_embed"])
    _stack(out, "encoder.attn_layers", enc["attn_layers"])
    _norm(out, "encoder.norm", enc["norm"])

    out["decoder.net.token_embedding.weight"] = np.asarray(dec["token_embedding"]["embedding"])
    out[POS_EMBED_KEY] = np.asarray(dec["pos_embedding"]["embedding"])
    _stack(out, "decoder.net.attn_layers", dec["attn_layers"])
    _norm(out, "decoder.net.norm", dec["norm"])
    out["decoder.net.to_logits.weight"] = _linear(dec["to_logits"]["kernel"])
    out["decoder.net.to_logits.bias"] = np.asarray(dec["to_logits"]["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """A reference state dict from a ``.pth``/``.pt`` file (a bare state dict
    or the {'model_state_dict': ...} training blob) or an ``.npz``."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    if path.endswith((".pth", ".pt")):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return dict(blob.get("model_state_dict", blob))
    raise ValueError(f"unknown checkpoint format: {path} (expected .pth, .pt or .npz)")


def _host_leaves(tree):
    """``tree`` with bfloat16 tensor leaves as float32 numpy arrays (exact)."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def load_jax_params(path: str) -> Dict[str, torch.Tensor]:
    """``state_dict_from_jax`` of a JAX training run's params: ``path`` is a
    JAX ``checkpoint_e*`` directory that holds ``params_cache.msgpack``, or
    that file. A directory without it raises ``ValueError``, which says how
    to write it."""
    path = str(path)
    if os.path.isdir(path):
        cache = os.path.join(path, JAX_PARAMS_CACHE)
        if not os.path.exists(cache):
            raise ValueError(
                f"{path} holds no {JAX_PARAMS_CACHE}: the port reads a JAX checkpoint's params "
                "from that file, not from its orbax files (they need tensorstore). Write it "
                "on a machine with JAX: python -c \"from texocr_tpu.checkpoint.orbax_io import "
                f"load_params_fast; load_params_fast('{path}')\"")
        path = cache
    with open(path, "rb") as f:
        return state_dict_from_jax(_host_leaves(msgpack.unpackb(f.read())))
