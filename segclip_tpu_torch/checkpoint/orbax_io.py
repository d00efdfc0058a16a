"""Orbax checkpoint directories without orbax or tensorstore: the port's
counterpart of segclip_tpu/checkpoint/orbax_io.py, with its five
functions and their meaning.

A directory that the JAX package's `StandardCheckpointer` writes holds

    _METADATA               JSON: `tree_metadata` (one entry per leaf, keyed
                            by its key path), `use_ocdbt`, `use_zarr3`
    _CHECKPOINT_METADATA    JSON: the handler and the timestamps
    _sharding               JSON: each array's sharding, by base64 name
    array_metadatas/        JSON: each array's write and chunk shapes
    manifest.ocdbt, d/, ocdbt.process_N/   the OCDBT store (checkpoint/ocdbt.py)

and each leaf is a zarr v2 array named by its key path joined with "."
(`params.clip.ln_final.bias`): the key `<name>/.zarray` holds its JSON
header, `<name>/<i>.<j>` its chunks in C order, each compressed with zstd
(checkpoint/zstd.py) or not at all. A save from a sharded array writes one
chunk per shard. Without OCDBT (`"use_ocdbt": false`) the same keys are
files under the directory.

`read_tree` gives the nested dict of the JAX tree, numpy arrays, with
bfloat16 leaves as torch.bfloat16 tensors (numpy has no bfloat16). The
training checkpoint's tree is {params, opt_state_mu, opt_state_nu,
opt_step, step, epoch}, written by the JAX package's `save_checkpoint`;
`restore_checkpoint` maps it into the port's model, AdaptAdamW and
TrainState. The writers (`save_params`, `save_checkpoint`) write what the
JAX package writes, uncompressed (OCDBT nodes with compression 0, zarr
arrays with `"compressor": null`), from the port's state dicts through
`convert.flax_params_from_state_dict`, so that the JAX package restores
them; the port's training loop keeps writing torch checkpoints
(checkpoint/io.py) and resumes from either kind.
"""
from __future__ import annotations

import base64
import json
import math
import os
import shutil
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from segclip_tpu_torch.checkpoint import ocdbt, zstd
from segclip_tpu_torch.checkpoint.convert import (fit_state_dict, flax_params_from_state_dict,
                                                  state_dict_from_jax)
from segclip_tpu_torch.checkpoint.io import auto_resume_path, _abs, _gc_old, load_training_state
from segclip_tpu_torch.train.optimizer import AdaptAdamW
from segclip_tpu_torch.train.step import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "save_params", "restore_params",
           "auto_resume_path", "is_orbax_dir", "read_tree"]

METADATA_FILE = "_METADATA"
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
# the device a sharding entry names: the port writes every array from the host
DEVICE_STR = "TFRT_CPU_0"
DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
          "bfloat16": np.uint16}
TRAIN_KEYS = ("params", "opt_state_mu", "opt_state_nu", "opt_step", "step", "epoch")


def is_orbax_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(_abs(path), METADATA_FILE))


class _DirStore:
    """The keys of a directory written without OCDBT: files by relative path."""

    def __init__(self, root: str):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def __getitem__(self, key: str) -> bytes:
        with open(os.path.join(self.root, key), "rb") as f:
            return f.read()

    def close(self) -> None:
        pass


def _read_array(store, name: str):
    """The zarr v2 array `name` of `store`: a numpy array, or a
    torch.bfloat16 tensor."""
    header = json.loads(store[f"{name}/.zarray"])
    if header.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {header.get('zarr_format')}")
    dtype_name = header["dtype"]
    if dtype_name not in DTYPES:
        raise ValueError(f"{name}: dtype {dtype_name!r} is not read (one of {sorted(DTYPES)})")
    if header.get("order", "C") != "C" or header.get("filters"):
        raise ValueError(f"{name}: order {header.get('order')} / filters {header.get('filters')}")
    compressor = header.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}")
    dtype = np.dtype(DTYPES[dtype_name])
    shape, chunks = tuple(header["shape"]), tuple(header["chunks"])
    sep = header.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, index)) if shape else "0")
        if key not in store:
            if header.get("fill_value") is None:
                raise ValueError(f"{name}: chunk {key} is missing and there is no fill value")
            raw = np.full(chunks, header["fill_value"], dtype).tobytes()
        else:
            raw = store[key]
            if compressor is not None:
                raw = zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{name}: chunk {key} holds {len(raw)} bytes, expected {chunk_bytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _metadata(path: str) -> dict:
    if not is_orbax_dir(path):
        raise ValueError(f"{path} is not an Orbax directory: no {METADATA_FILE}")
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: \"use_zarr3\": true in {METADATA_FILE}; only zarr v2 "
                         f"directories are read")
    return meta


def read_tree(path: str, top: Optional[str] = None) -> dict:
    """The tree an Orbax directory holds, as nested dicts of numpy arrays
    (bfloat16 leaves as torch.bfloat16 tensors); with `top`, only that
    top-level key's subtree."""
    path = _abs(path)
    meta = _metadata(path)
    store = ocdbt.OcdbtStore(path) if meta.get("use_ocdbt", True) else _DirStore(path)
    tree: dict = {}
    try:
        for entry in meta["tree_metadata"].values():
            keys = [k["key"] for k in entry["key_metadata"]]
            if top is not None and keys[0] != top:
                continue
            if entry["value_metadata"].get("skip_deserialize"):
                continue
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = _read_array(store, ".".join(keys))
    finally:
        store.close()
    if top is not None and top not in tree:
        raise KeyError(f"{path} holds no {top!r} tree")
    return tree


def _float32(tree: dict) -> dict:
    """The tree's leaves as float32 numpy (bfloat16 exactly widened)."""
    return {k: _float32(v) if isinstance(v, dict) else
            (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in tree.items()}


def patch_size(params: dict) -> int:
    """The patch size of a JAX SegCLIP tree, from `clip/visual/conv1`
    (3·p·p rows)."""
    rows = params["clip"]["visual"]["conv1"].shape[0]
    p = math.isqrt(rows // 3)
    if 3 * p * p != rows:
        raise ValueError(f"clip/visual/conv1 has {rows} rows, not 3·p·p")
    return p


def state_dict_from_tree(params: dict) -> Dict[str, torch.Tensor]:
    """A JAX params tree (as read) → the reference-layout state dict, float32."""
    return state_dict_from_jax(_float32(params), vision_patch_size=patch_size(params))


def restore_params(path: str) -> dict:
    """The `params` tree of a save_params directory OR of a full training
    checkpoint (the JAX function's PyTreeRestore fallback): evaluating a
    mid-training ckpt_epoch_N directly."""
    return read_tree(path, top="params")["params"]


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer: AdaptAdamW,
                       state: TrainState,
                       shard: Optional[Callable[[dict, dict], Tuple[dict, dict]]] = None
                       ) -> Tuple[TrainState, int]:
    """Load a JAX training checkpoint into `model` and `optimizer` in place
    (the arguments of checkpoint/io.restore_checkpoint): params through
    `state_dict_from_jax`, the moments through the same key mapping into
    AdaptAdamW's exp_avg / exp_avg_sq in its moment_dtype, `opt_step` into
    `optimizer.step_count`, `step` into TrainState.step. The seed stays
    `state.seed` (the config's): JAX's payload carries no rng, and its own
    restore keeps the fresh state's. Returns (TrainState, epoch). A leaf the
    model has no parameter for raises, and so does a parameter the
    directory lacks (a decoder the configuration does not build is dropped,
    as `convert.load_into` drops it)."""
    tree = read_tree(path)
    missing = [k for k in TRAIN_KEYS if k not in tree]
    if missing:
        raise KeyError(f"{path} is not a training checkpoint: no {missing}")
    p = patch_size(tree["params"])
    model_state, _ = fit_state_dict(model, state_dict_from_tree(tree["params"]))
    lacking = sorted(set(model.state_dict()) - set(model_state))
    if lacking:
        raise KeyError(f"parameters the directory lacks: {lacking[:5]}")
    moments = {}
    for key, slot in (("opt_state_mu", "exp_avg"), ("opt_state_nu", "exp_avg_sq")):
        sd = state_dict_from_jax(_float32(tree[key]), vision_patch_size=p)
        moments[slot], _ = fit_state_dict(model, sd)
    template = optimizer.state_dict()
    opt_state = {}
    for group in template["param_groups"]:
        for i, name in zip(group["params"], group["param_names"]):
            opt_state[i] = {slot: moments[slot][name].to(optimizer.moment_dtype)
                            for slot in moments}
    optimizer_state = {"state": opt_state, "param_groups": template["param_groups"]}
    load_training_state(model, optimizer, model_state, optimizer_state, shard)
    optimizer.step_count = int(tree["opt_step"])
    return TrainState(step=int(tree["step"]), seed=state.seed), int(tree["epoch"])


def _leaf_bytes(value) -> Tuple[str, tuple, memoryview]:
    """(zarr dtype, shape, C-order bytes) of a tensor or numpy leaf."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return ("bfloat16", tuple(value.shape),
                    memoryview(value.contiguous().view(torch.int16).numpy()).cast("B"))
        value = value.numpy()
    value = np.asarray(value, order="C")        # keeps a 0-d leaf 0-d
    names = {np.dtype(v): k for k, v in DTYPES.items() if k != "bfloat16"}
    if value.dtype not in names:
        raise ValueError(f"dtype {value.dtype} is not written")
    return names[value.dtype], value.shape, memoryview(value).cast("B") if value.size else b""


def _flatten(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _write_tree(path: str, tree: dict, numpy_keys: tuple = ()) -> str:
    """Write `tree` as the JAX package's StandardCheckpointer does, one
    chunk per array, uncompressed; whole under a temporary name, then
    renamed. Leaves under `numpy_keys` are recorded as numpy leaves."""
    t0 = time.time_ns()
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    values, tree_meta, array_meta, sharding = {}, {}, [], {}
    for keys, leaf in _flatten(tree):
        name = ".".join(keys)
        dtype, shape, data = _leaf_bytes(leaf)
        values[f"{name}/.zarray"] = json.dumps(
            {"chunks": list(shape), "compressor": None, "dimension_separator": ".",
             "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
             "shape": list(shape), "zarr_format": 2}, separators=(",", ":")).encode()
        values[f"{name}/" + (".".join("0" * len(shape)) if shape else "0")] = data
        value_meta = {"value_type": "np.ndarray", "skip_deserialize": False}
        if keys[0] not in numpy_keys:
            value_meta = {"value_type": "jax.Array", "skip_deserialize": False,
                          "write_shape": list(shape)}
            array_meta.append({"array_metadata": {"param_name": name, "write_shape": list(shape),
                                                  "chunk_shape": list(shape),
                                                  "ext_metadata": None}})
            sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                {"sharding_type": "SingleDeviceSharding", "device_str": DEVICE_STR})
        tree_meta[repr(keys)] = {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                                 "value_metadata": value_meta}
    ocdbt.write_store(tmp, values)
    files = {
        METADATA_FILE: {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                        "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
        "_sharding": sharding,
        "array_metadatas/process_0": {"array_metadatas": array_meta},
        "_CHECKPOINT_METADATA": {"item_handlers": HANDLER, "metrics": {},
                                 "performance_metrics": {}, "init_timestamp_nsecs": t0,
                                 "commit_timestamp_nsecs": time.time_ns(),
                                 "custom_metadata": {}},
    }
    for name, content in files.items():
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(content, f, separators=(",", ":") if name == "_sharding" else None)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def _params_tree(model_state: Dict[str, torch.Tensor]) -> dict:
    return flax_params_from_state_dict({k: v.detach().cpu() for k, v in model_state.items()})


def save_params(output_dir: str, name: str, model_state: Dict[str, torch.Tensor]) -> str:
    """Model-weights-only save (the --init-model role) of a reference-layout
    state dict (`SegCLIP.state_dict()`) as the JAX tree {params}."""
    path = os.path.join(_abs(output_dir), name)
    os.makedirs(_abs(output_dir), exist_ok=True)
    return _write_tree(path, {"params": _params_tree(model_state)})


def save_checkpoint(output_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: AdaptAdamW, state: TrainState,
                    max_kept: int = -1, name: Optional[str] = None,
                    state_dicts: Optional[Tuple[dict, dict]] = None) -> str:
    """Save the training state under <output_dir>/<name or ckpt_epoch_<epoch>>
    as the JAX package's save_checkpoint does: {params, opt_state_mu,
    opt_state_nu, opt_step, step, epoch}, the moments of every parameter in
    the optimizer's moment_dtype (zeros where the optimizer holds none: a
    frozen parameter, or before the first step, as JAX's init). The
    arguments are those of checkpoint/io.save_checkpoint."""
    model_state, optimizer_state = state_dicts or (model.state_dict(), optimizer.state_dict())
    names = {}
    for group in optimizer_state["param_groups"]:
        names.update(zip(group["params"], group["param_names"]))
    held = {names[i]: m for i, m in optimizer_state["state"].items()}
    trees = {}
    for key, slot in (("opt_state_mu", "exp_avg"), ("opt_state_nu", "exp_avg_sq")):
        trees[key] = _params_tree({
            k: held[k][slot] if k in held and slot in held[k]
            else torch.zeros(v.shape, dtype=optimizer.moment_dtype)
            for k, v in model_state.items()})
    tree = {"params": _params_tree(model_state), **trees,
            "opt_step": np.asarray(optimizer.step_count, np.int32),
            "step": np.asarray(state.step, np.int32),
            "epoch": np.asarray(epoch, np.int32)}
    os.makedirs(_abs(output_dir), exist_ok=True)
    path = _write_tree(os.path.join(_abs(output_dir), name or f"ckpt_epoch_{epoch}"), tree,
                       numpy_keys=("epoch",))
    if max_kept > 0:
        _gc_old(output_dir, max_kept)
    return path
