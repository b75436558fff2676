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

``jax_from_state_dict`` goes the other way (the counterpart of
``torch_shim.convert_torch_state_dict``), and ``optimizer_state_from_jax`` and
``jax_opt_state`` carry the optimizer's state across: optax's Adam, AdamW and
SGD chains against the payload of the port's ``Optimizer.state_dict()``.

``load_jax_params`` reads the params of a JAX training run's ``checkpoint_e*``
directory: from the ``params_cache.msgpack`` that the JAX package's
``load_params_fast`` keeps there where it exists (flax's msgpack, read by
``checkpoint/msgpack.py`` without the ``msgpack`` package), else from the
orbax files themselves (``checkpoint/orbax.py``, without tensorstore).
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict

import numpy as np
import torch

from texocr_tpu_torch.checkpoint import msgpack, orbax

POS_EMBED_KEY = "decoder.net.pos_embedding.embedding.weight"


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
    cross-attention, each as the tree holds it. Leaves: arrays or tensors
    (``torch.bfloat16`` ones, as the msgpack and orbax readers give
    bfloat16, are widened exactly)."""
    params = _host_leaves(params.get("params", params))
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


class _Taker:
    """Takes reference keys from a state dict, each once, as numpy arrays;
    ``left()`` names what was never taken."""

    def __init__(self, state: Dict):
        self.state = state
        self.used = set()

    def has(self, key: str) -> bool:
        return key in self.state

    def take(self, key: str) -> np.ndarray:
        if key not in self.state:
            raise KeyError(f"the state dict has no {key}")
        self.used.add(key)
        value = self.state[key]
        return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)

    def same(self, key: str, first: np.ndarray) -> None:
        """Takes ``key`` where present, a registration of ``first``'s tensor
        under another name, and checks that it holds the same values."""
        if self.has(key) and not np.array_equal(self.take(key), first):
            raise ValueError(f"{key} differs from the tensor it shares")

    def left(self):
        return sorted(set(self.state) - self.used)


def _unlinear(t: _Taker, key: str) -> np.ndarray:
    return np.ascontiguousarray(t.take(key).T)


def _unconv(t: _Taker, key: str) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(t.take(key), (2, 3, 1, 0)))


def _unnorm(t: _Taker, prefix: str) -> dict:
    return {"scale": t.take(f"{prefix}.weight"), "bias": t.take(f"{prefix}.bias")}


def _unmha(t: _Taker, prefix: str) -> dict:
    out = {name: {"kernel": _unlinear(t, f"{prefix}.{name}.weight")} for name in ("q", "k", "v")}
    out["fc_out"] = {"kernel": _unlinear(t, f"{prefix}.fc_out.0.weight"),
                     "bias": t.take(f"{prefix}.fc_out.0.bias")}
    return out


def _unstack(t: _Taker, prefix: str) -> dict:
    """The inverse of ``_stack``: sub-layer j of ``layers.{j}`` is attention
    where it has ``q``, an MLP otherwise; each layer is self-attention,
    cross-attention where there are three sub-layers per MLP, and the MLP."""
    subs = {int(m.group(1)) for k in t.state
            if (m := re.match(rf"{re.escape(prefix)}\.layers\.(\d+)\.1\.", k))}
    n_sub = max(subs) + 1
    n_layers = len([j for j in subs if not t.has(f"{prefix}.layers.{j}.1.q.weight")])
    per = n_sub // n_layers
    out = {"shared_norm": _unnorm(t, f"{prefix}.layers.0.0")}
    for j in range(1, n_sub):
        for name in ("weight", "bias"):
            t.same(f"{prefix}.layers.{j}.0.{name}",
                   out["shared_norm"]["scale" if name == "weight" else "bias"])
    for layer in range(n_layers):
        base = layer * per
        out[f"self_attns_{layer}"] = _unmha(t, f"{prefix}.layers.{base}.1")
        if per == 3:
            out[f"cross_attns_{layer}"] = _unmha(t, f"{prefix}.layers.{base + 1}.1")
        mprefix = f"{prefix}.layers.{base + per - 1}.1"
        glu = t.has(f"{mprefix}.fc_in.fc.weight")
        fc_in = f"{mprefix}.fc_in.fc" if glu else f"{mprefix}.fc_in.0"
        out[f"mlps_{layer}"] = {
            "fc_in": {"kernel": _unlinear(t, f"{fc_in}.weight"), "bias": t.take(f"{fc_in}.bias")},
            "fc_out": {"kernel": _unlinear(t, f"{mprefix}.fc_out.weight"),
                       "bias": t.take(f"{mprefix}.fc_out.bias")}}
    return out


def _unbottleneck(t: _Taker, prefix: str) -> dict:
    out = {}
    for i, (conv, norm) in enumerate((("conv1", "norm1"), ("conv2", "norm2"), ("conv3", "norm3"))):
        out[conv] = {"kernel": _unconv(t, f"{prefix}.block_list.{2 * i}.weight")}
        out[norm] = _unnorm(t, f"{prefix}.block_list.{2 * i + 1}")
        # nn.Sequential(*block_list) registers the same tensors under block.{i}.
        t.same(f"{prefix}.block.{2 * i}.weight", t.take(f"{prefix}.block_list.{2 * i}.weight"))
        for name in ("weight", "bias"):
            t.same(f"{prefix}.block.{2 * i + 1}.{name}",
                   t.take(f"{prefix}.block_list.{2 * i + 1}.{name}"))
    if t.has(f"{prefix}.downsample.conv.weight"):
        out["proj_conv"] = {"kernel": _unconv(t, f"{prefix}.downsample.conv.weight")}
        out["proj_norm"] = _unnorm(t, f"{prefix}.downsample.norm")
    return out


def _count(t: _Taker, pattern: str) -> int:
    return len({m.group(1) for k in t.state if (m := re.match(pattern, k))})


def jax_from_state_dict(state: Dict) -> dict:
    """Reference-keyed tensors or arrays -> the JAX ``{'encoder': ...,
    'decoder': ...}`` parameter tree, as numpy arrays in their own dtype:
    the inverse of ``state_dict_from_jax`` and the counterpart of
    ``torch_shim.convert_torch_state_dict``. The shared LayerNorm comes from
    ``layers.0.0`` and the bottlenecks' tensors from ``block_list``; their
    other registrations (``layers.{j}.0``, ``block``) must hold the same
    values where the dict has them (a model's ``named_parameters`` names each
    tensor once). A key the tree has no place for raises ``ValueError``."""
    t = _Taker(state)
    enc: dict = {}
    proj = "encoder.patch_embed.proj"
    bb = "encoder.patch_embed.backbone_net"
    if t.has(f"{bb}.stem.0.weight"):
        backbone = {"stem_conv": {"kernel": _unconv(t, f"{bb}.stem.0.weight")},
                    "stem_norm": _unnorm(t, f"{bb}.stem.1")}
        for s in range(_count(t, rf"{re.escape(bb)}\.stages\.(\d+)\.")):
            blocks = _count(t, rf"{re.escape(bb)}\.stages\.{s}\.stage_blocks\.(\d+)\.")
            backbone[f"stage{s}"] = {
                f"block{i}": _unbottleneck(t, f"{bb}.stages.{s}.stage_blocks.{i}")
                for i in range(blocks)}
        enc["backbone"] = backbone
        enc["proj"] = {"kernel": np.ascontiguousarray(t.take(f"{proj}.weight")[:, :, 0, 0].T),
                       "bias": t.take(f"{proj}.bias")}
    else:  # the grey patch embed: (D, 1, p, p) -> (p * p, D), ordered (py, px)
        weight = t.take(f"{proj}.weight")
        kernel = weight.transpose(2, 3, 1, 0).reshape(-1, weight.shape[0])
        enc["patch_embed"] = {"kernel": np.ascontiguousarray(kernel),
                              "bias": t.take(f"{proj}.bias")}
    enc["cls_token"] = t.take("encoder.cls_token")
    enc["pos_embed"] = t.take("encoder.pos_embed")
    enc["attn_layers"] = _unstack(t, "encoder.attn_layers")
    enc["norm"] = _unnorm(t, "encoder.norm")
    dec = {"token_embedding": {"embedding": t.take("decoder.net.token_embedding.weight")},
           "pos_embedding": {"embedding": t.take(POS_EMBED_KEY)},
           "attn_layers": _unstack(t, "decoder.net.attn_layers"),
           "norm": _unnorm(t, "decoder.net.norm"),
           "to_logits": {"kernel": _unlinear(t, "decoder.net.to_logits.weight"),
                         "bias": t.take("decoder.net.to_logits.bias")}}
    if t.left():
        raise ValueError(f"keys with no place in the JAX tree: {t.left()}")
    return {"encoder": enc, "decoder": dec}


# Registrations of a tensor under a second name (the shared LayerNorm of
# sub-layers 1.., the bottlenecks' ``block`` aliases of ``block_list``): a
# model's parameters and their optimizer state name each tensor once.
_ALIAS = re.compile(r"(\.layers\.[1-9]\d*\.0\.|\.block\.\d+\.)")

# optax states the port maps, by their fields.
_ADAM = frozenset({"count", "mu", "nu"})
_TRACE = frozenset({"trace"})
_SCHEDULE = frozenset({"count"})


def _parameters(tree: dict) -> Dict[str, torch.Tensor]:
    """``state_dict_from_jax`` of a params-shaped tree, each tensor once."""
    return {k: v for k, v in state_dict_from_jax(tree).items()
            if not _ALIAS.search(k)}


def optimizer_state_from_jax(opt_state) -> dict:
    """optax's state of the JAX package's ``get_optimizer`` chains (Adam or
    AdamW, with or without ``grad_clip`` and ``lr_schedule`` and weight
    decay, SGD with or without momentum) -> the payload of the port's
    ``Optimizer.state_dict()``, its per-parameter state named by reference
    key rather than numbered (``parallel/sharding.py`` numbers it in the
    model's order) and without param groups (the live optimizer keeps its
    own hyperparameters). ``ScaleByAdamState`` wherever the chain puts it:
    ``mu``/``nu`` -> ``exp_avg``/``exp_avg_sq`` through the params' layout
    transforms and ``count`` -> each parameter's ``step``; ``TraceState``
    -> ``momentum_buffer``; ``ScaleByScheduleState.count`` -> the
    ``LambdaLR`` position. ``EmptyState`` (None) maps to nothing; any other
    state raises ``ValueError`` naming its path."""
    per_param: Dict[str, dict] = {}
    out: dict = {"optimizer": {"state": per_param}}

    def visit(node, path):
        if node is None:
            return
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                visit(child, f"{path}.{i}")
            return
        fields = frozenset(node) if isinstance(node, dict) else None
        if fields == _ADAM:
            count = float(np.asarray(node["count"]))
            for name, tree in (("exp_avg", node["mu"]), ("exp_avg_sq", node["nu"])):
                for key, value in _parameters(tree).items():
                    per_param.setdefault(key, {})[name] = value
                    per_param[key]["step"] = torch.tensor(count)
        elif fields == _TRACE:
            for key, value in _parameters(node["trace"]).items():
                per_param.setdefault(key, {})["momentum_buffer"] = value
        elif fields == _SCHEDULE:
            out["scheduler"] = {"last_epoch": int(np.asarray(node["count"]))}
        else:
            what = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{path}: optax state {what} has no counterpart in the port")

    visit(opt_state, "opt_state")
    return out


def _optax_layout(name: str, args: dict) -> list:
    """The state tree the JAX package's ``get_optimizer(name, args)`` chain
    inits, with each state named: None (``EmptyState``), "adam", "trace" or
    "schedule"."""
    schedule = "schedule" if args.get("lr_schedule") else None
    clip = [None] if args.get("grad_clip") else []
    decay = [None] if args.get("weight_decay") else []
    kind = name.lower()
    if kind == "adam":
        return clip + decay + ["adam", schedule]
    if kind == "adamw":
        return clip + [["adam", None, schedule]]
    if kind == "sgd":
        return clip + decay + [["trace" if args.get("momentum") else None, schedule]]
    raise ValueError(f"unknown optimizer: {name!r}")


def jax_opt_state(state: dict, keys, name: str, args: dict) -> list:
    """The port's ``Optimizer.state_dict()`` payload (numbered in the order of
    ``keys``, ``OCRModel.parameter_keys()``) -> the optax state tree of the
    JAX package's ``get_optimizer(name, args)``: lists for the chains, None
    for ``EmptyState`` and dicts of fields, as ``orbax.save_checkpoint``
    writes and the JAX package restores. Every parameter must have the
    buffers the chain keeps (once the optimizer has stepped), with one Adam
    step count."""
    per_param = {keys[i]: buffers for i, buffers in state["optimizer"]["state"].items()}

    def tree(buffer):
        missing = [k for k in keys if buffer not in per_param.get(k, {})]
        if missing:
            raise ValueError(f"no {buffer} for {missing[:3]} ({len(missing)} parameters)")
        return jax_from_state_dict({k: b[buffer] for k, b in per_param.items()})

    def fill(layout):
        if isinstance(layout, list):
            return [fill(x) for x in layout]
        if layout == "adam":
            steps = {int(b["step"]) for b in per_param.values()}
            if len(steps) != 1:
                raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
            return {"count": np.asarray(steps.pop(), np.int32), "mu": tree("exp_avg"),
                    "nu": tree("exp_avg_sq")}
        if layout == "trace":
            return {"trace": tree("momentum_buffer")}
        if layout == "schedule":
            return {"count": np.asarray(state["scheduler"]["last_epoch"], np.int32)}
        return None

    return fill(_optax_layout(name, args))


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
    JAX ``checkpoint_e*`` directory (its ``params_cache.msgpack`` where the
    JAX package wrote one, else its orbax files), or that msgpack file. A
    directory that is neither raises ``ValueError``."""
    path = str(path)
    if os.path.isdir(path):
        cache = os.path.join(path, orbax.PARAMS_CACHE)
        if not (os.path.exists(cache) or orbax.is_checkpoint(path)):
            raise ValueError(f"{path} is not a JAX checkpoint directory: it holds neither "
                             f"{orbax.METADATA} nor {orbax.PARAMS_CACHE}")
        return state_dict_from_jax(orbax.load_params_fast(path))
    with open(path, "rb") as f:
        return state_dict_from_jax(msgpack.unpackb(f.read()))
