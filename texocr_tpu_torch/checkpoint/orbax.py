"""The JAX package's orbax checkpoints (``checkpoint/orbax_io.py`` there),
read and written without JAX, orbax or tensorstore.

A ``save_dir/checkpoint_e{epoch}/`` directory holds ``_METADATA`` (JSON: each
leaf's key path, the kind of each key, 1 a sequence index and 2 a dict key,
and the leaf's type), an OCDBT store (``ocdbt.py``) and, from orbax, more
JSON that restoring does not need. The store holds one zarr v2 array per
leaf, named by the leaf's keys joined with ``.``: ``<name>/.zarray`` (JSON:
dtype, shape, chunks, C order, zstd at level 1, ``.`` between chunk indices)
and a zstd frame per chunk, ``<name>/0.0`` and so on (``<name>/0`` for a
scalar). A leaf sharded over a mesh has one chunk per shard.

Leaves come back as numpy arrays, Python scalars (``value_type`` "scalar":
``epoch``, ``step``) and None (an ``optax.EmptyState``, which stores no
array), in the tree's own nesting: dicts for dict keys and lists for
sequence indices, so an optax chain's state is a list in chain order and
each of its states a dict of fields. ``bfloat16`` (which numpy does not have)
is read as uint16 and viewed as a ``torch.bfloat16`` tensor, exactly, as
``checkpoint/msgpack.py`` reads it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from texocr_tpu_torch.checkpoint import msgpack, ocdbt, zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
PARAMS_CACHE = "params_cache.msgpack"
KEY_SEQUENCE, KEY_DICT = 1, 2
ZSTD_LEVEL = 1


def _path(save_dir: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(save_dir, f"checkpoint_e{epoch}"))


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, METADATA))


def _dtype(name: str) -> np.dtype:
    return np.dtype("<u2") if name == "bfloat16" else np.dtype(name)


def _read_array(store: Dict[bytes, bytes], name: str, where: str):
    """The zarr v2 array ``name`` of ``store``, from every chunk."""
    meta = store.get(f"{name}/.zarray".encode())
    if meta is None:
        raise ValueError(f"{where}: no array {name!r} in the store")
    meta = json.loads(meta)
    if meta.get("filters") or meta.get("order") != "C" or (
            (meta.get("compressor") or {}).get("id") != "zstd"):
        raise ValueError(f"{where}: {name} is stored as {meta}, which this reader does not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = _dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    whole = chunks == shape and f"{name}/{sep.join('0' * len(shape)) or '0'}".encode() in store
    out = None if whole else np.zeros(shape, dtype)
    for index in np.ndindex(*grid):
        raw = store.get(f"{name}/{sep.join(map(str, index)) or '0'}".encode())
        if raw is None:  # never written: the fill value (null, read as zeros)
            continue
        block = np.frombuffer(zstd.decompress(raw, math.prod(chunks) * dtype.itemsize),
                              dtype).reshape(chunks)
        if whole:  # one chunk: the array itself, on the decompressed buffer
            out = block
            break
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _nest(node: dict) -> Any:
    """A built node: its sequence-keyed children as a list in index order."""
    if not isinstance(node, dict) or "__seq__" not in node:
        return node
    children = {k: _nest(v) for k, v in node.items() if k != "__seq__"}
    if node["__seq__"]:
        return [children.get(i) for i in range(max(children) + 1)] if children else []
    return children


def load_checkpoint(path: str) -> dict:
    """The tree of an orbax checkpoint directory, as the module docstring
    says."""
    path = os.path.abspath(str(path))
    with open(os.path.join(path, METADATA)) as f:
        tree_metadata = json.load(f)["tree_metadata"]
    store = ocdbt.read_store(path)
    root: dict = {"__seq__": False}
    for entry in tree_metadata.values():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(str(k["key"]) for k in keys)
        if kind in ("jax.Array", "np.ndarray"):
            value = _read_array(store, name, path)
        elif kind == "scalar":
            value = _read_array(store, name, path).item()
        elif kind == "None":
            value = None
        else:
            raise ValueError(f"{path}: {name} has value type {kind!r}, which this reader does "
                             "not read")
        node = root
        for here, below in zip(keys, keys[1:] + [None]):
            key = int(here["key"]) if here["key_type"] == KEY_SEQUENCE else here["key"]
            if below is None:
                node[key] = value
            else:
                node = node.setdefault(key, {"__seq__": below["key_type"] == KEY_SEQUENCE})
    return _nest(root)


def _leaves(tree, prefix=()):
    """(key path, key types, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + ((str(i), KEY_SEQUENCE),))
    else:
        yield prefix, tree


def _host(value) -> Tuple[np.ndarray, str]:
    """``value`` as a little-endian C-order array and its zarr dtype."""
    if torch.is_tensor(value):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view("<u2"), "bfloat16"
        value = value.numpy()
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return np.asarray(array, order="C").view("<u2"), "bfloat16"
    array = np.asarray(array, array.dtype.newbyteorder("<"), order="C")
    return array, array.dtype.str


def _zarr(name: str, value, items: Dict[bytes, bytes]) -> None:
    """Stores ``value`` in ``items`` as a zarr array of one chunk."""
    array, dtype = _host(value)
    meta = {"chunks": [max(s, 1) for s in array.shape],
            "compressor": {"id": "zstd", "level": ZSTD_LEVEL}, "dimension_separator": ".",
            "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
            "shape": list(array.shape), "zarr_format": 2}
    items[f"{name}/.zarray".encode()] = json.dumps(meta, sort_keys=True,
                                                   separators=(",", ":")).encode()
    chunk = ".".join("0" for _ in array.shape) or "0"
    items[f"{name}/{chunk}".encode()] = zstd.compress(array.tobytes(), ZSTD_LEVEL)


def save_checkpoint(save_dir: str, epoch: int, params, opt_state=None, extra=None) -> str:
    """Writes ``save_dir/checkpoint_e{epoch}/`` as the JAX package's
    ``orbax_io.save_checkpoint`` lays it out (``params``, ``epoch``, the
    ``opt_state`` if given and the ``extra`` entries), which its
    ``load_checkpoint`` restores with a template and without one. Leaves:
    numpy arrays and CPU or CUDA tensors (``torch.bfloat16`` as bfloat16),
    Python ints and floats (scalars), and None (an ``optax.EmptyState``);
    an optax chain's state is a list or tuple in chain order, each state a
    dict of its fields. Each array is one chunk. An existing directory of
    that epoch is replaced, as orbax's ``force=True`` does. Returns the
    directory."""
    payload = {"params": params, "epoch": int(epoch)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    payload.update(extra or {})
    items: Dict[bytes, bytes] = {}
    tree_metadata = {}
    for keys, leaf in _leaves(payload):
        name = ".".join(k for k, _ in keys)
        if leaf is None:
            value_meta = {"value_type": "None", "skip_deserialize": True}
        else:
            _zarr(name, leaf, items)
            kind = "scalar" if isinstance(leaf, (int, float)) else "np.ndarray"
            value_meta = {"value_type": kind, "skip_deserialize": False}
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value_meta}
    path = _path(save_dir, epoch)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    ocdbt.write_store(tmp, items)
    now = time.time_ns()
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                   "PyTreeCheckpointHandler", "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def load_params_fast(path: str) -> Any:
    """The ``params`` of a checkpoint directory: from its
    ``params_cache.msgpack`` where the JAX package wrote one (flax's msgpack,
    ``checkpoint/msgpack.py``), else from its orbax files. Writes no cache."""
    cache = os.path.join(os.path.abspath(str(path)), PARAMS_CACHE)
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return msgpack.unpackb(f.read())
    return load_checkpoint(path)["params"]


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Highest-epoch checkpoint_e* directory, or None."""
    if not os.path.isdir(save_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(save_dir):
        if name.startswith("checkpoint_e"):
            try:
                epoch = int(name[len("checkpoint_e"):])
            except ValueError:
                continue
            if epoch > best_epoch:
                best, best_epoch = os.path.join(save_dir, name), epoch
    return best
