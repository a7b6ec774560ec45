"""Dependency-free tree checkpointing, npz + json metadata
(``repro.training.checkpoints``, the same file format).

A checkpoint is the pair (``<name>.npz``, ``<name>.json``) committed
atomically: both are staged in a temp dir beside the target and fsynced,
then the npz and after it the json are ``os.replace``d into place. The
json carries a CRC32 of the npz bytes, so it is the commit record: a torn
pair raises ``CheckpointError`` on load. Keys are the flat paths of the
reference's ``_flatten`` (``params/blocks/attn/wq``, ``#i`` for list
items), so a file written by either package loads in the other.
``load_checkpoint`` returns numpy arrays, as the reference;
``models.params.from_jax`` turns a params subtree into a ``ParamTree``.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import ParamTree

# metadata keys owned by the checkpoint format itself
_CHECKSUM_KEY = "__npz_crc32__"
_FORMAT_KEY = "__format__"
_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """Missing, torn, or corrupt checkpoint."""


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        # numpy has no bfloat16: written as float32, which holds it exactly
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree, path="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, (dict, ParamTree)):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{path}/{k}" if path else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{path}/#{i}"))
    else:
        out[path] = _leaf(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [fix(node[f"#{i}"]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _paths(path: str) -> Tuple[str, str]:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".json"


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write ``tree`` (npz) + ``metadata`` (json) as one unit:
    staged and fsynced in a temp dir on the same filesystem, then published
    npz first, json (which embeds the npz checksum) second."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    npz_path, meta_path = _paths(path)
    flat = _flatten(tree)
    tmpdir = tempfile.mkdtemp(dir=directory, prefix=".ckpt-tmp-")
    try:
        tmp_npz = os.path.join(tmpdir, "tree.npz")
        tmp_meta = os.path.join(tmpdir, "meta.json")
        with open(tmp_npz, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        meta = dict(metadata or {})
        meta[_CHECKSUM_KEY] = _file_crc32(tmp_npz)
        meta[_FORMAT_KEY] = _FORMAT_VERSION
        with open(tmp_meta, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, npz_path)
        os.replace(tmp_meta, meta_path)
        _fsync_dir(directory)
    finally:
        for name in ("tree.npz", "meta.json"):
            p = os.path.join(tmpdir, name)
            if os.path.exists(p):
                os.unlink(p)
        os.rmdir(tmpdir)


def load_checkpoint(path: str, verify: bool = True
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Load (tree of numpy arrays, metadata); with ``verify`` (default)
    check the npz against the committed checksum and raise
    ``CheckpointError`` on a torn or corrupt pair."""
    npz_path, meta_path = _paths(path)
    if not os.path.exists(npz_path):
        raise CheckpointError(f"checkpoint not found: {npz_path}")
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except ValueError as e:
            raise CheckpointError(
                f"corrupt checkpoint metadata {meta_path}: {e}") from e
    elif verify:
        raise CheckpointError(
            f"checkpoint {npz_path} has no committed metadata "
            f"({meta_path} missing): torn write?")
    if verify and _CHECKSUM_KEY in meta:
        crc = _file_crc32(npz_path)
        if crc != int(meta[_CHECKSUM_KEY]):
            raise CheckpointError(
                f"checkpoint checksum mismatch for {npz_path}: npz crc32 "
                f"{crc:#010x} != committed {int(meta[_CHECKSUM_KEY]):#010x}"
                " (torn write?)")
    try:
        with np.load(npz_path) as data:
            flat = {k: data[k] for k in data.files}
    except Exception as e:  # zipfile/np errors on truncated files
        raise CheckpointError(f"unreadable checkpoint {npz_path}: {e}") from e
    meta = {k: v for k, v in meta.items()
            if k not in (_CHECKSUM_KEY, _FORMAT_KEY)}
    return _unflatten(flat), meta


def restore_sharded(path: str, shardings: Any
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint and place every leaf on its mesh sharding.

    ``shardings`` mirrors the saved tree (e.g. from
    ``models.model.param_shardings``: ``distributed.sharding.Sharding``
    leaves). On a mesh of more than one device each rank keeps only its
    local shard of each leaf (``DTensor.from_local`` in the sharding's
    placements, on the mesh's device type); on a one-device mesh the leaf
    goes whole onto the device (the card when the mesh's device type is
    "cuda"). Leaves keep the saved dtype (bf16 leaves were written as
    float32, which holds them exactly)."""
    from repro_torch.distributed.sharding import is_distributed, shard_tensor
    tree, meta = load_checkpoint(path)

    def place(arr, sh):
        if isinstance(arr, dict):
            return {k: place(arr[k], sh[k]) for k in arr}
        device = sh.mesh.device_type
        if device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        t = torch.from_numpy(np.array(arr, copy=True))
        if is_distributed(sh.mesh):
            return shard_tensor(t, sh, device=device)
        return t.to(device)

    return place(tree, shardings), meta
