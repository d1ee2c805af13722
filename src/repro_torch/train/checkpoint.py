"""Fault-tolerant checkpointing: step-atomic, zlib-compressed, elastic.

Layout (one directory per step), the JAX package's:
    ckpt_dir/
      step_00000123/
        meta.json            # step, time, codec, and per leaf its key,
                             # dtype, shape, shard file and byte offset
        shard_00000.bin      # zlib of the concatenated raw leaf bytes
        COMMIT               # written last: absence marks a torn checkpoint

The format needs only the standard library and numpy (the JAX package packs
msgpack and optionally zstd, which the port does not use), so the port does
not read the JAX package's checkpoints, nor it the port's.  Leaves are
stored unsharded and logical, bf16 as its 16-bit pattern (the reference's
uint16 view).

Fault-tolerance contract:
  * writes go to ``step_X.tmp``, then an atomic rename: partial writes are
    never visible; ``latest()`` only returns committed steps.
  * ``restore`` validates shapes against the target tree and returns full
    logical CPU tensors: a checkpoint saved on any mesh loads onto any
    other, each rank cutting its shard (``parallel.sharding.shard_params``).
  * ``keep_last`` garbage-collects old steps after a successful commit.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_path, tree_unflatten

CODEC = "zlib-raw"  # raw leaf bytes, zlib-compressed; not the JAX package's format
_CHUNK = 64 * 1024 * 1024  # shard file target size (uncompressed)
_WIRE = {torch.bfloat16: torch.int16}  # dtypes numpy lacks, by their bits


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype in _WIRE:
        t = t.view(_WIRE[t.dtype])
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    dt = getattr(torch, dtype)
    wire = _WIRE.get(dt, dt)
    np_dtype = torch.empty((), dtype=wire).numpy().dtype
    t = torch.from_numpy(np.frombuffer(data, dtype=np_dtype).copy()).reshape(shape)
    return t.view(dt) if wire is not dt else t


def save(ckpt_dir: str | os.PathLike, step: int, tree, *, keep_last: int = 3,
         extra_meta: Optional[dict] = None) -> Path:
    """Write ``tree`` (a pytree of tensors, full logical leaves) as step
    ``step``; returns the committed directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, _ = tree_flatten_with_path(tree)
    meta = {"step": step, "time": time.time(), "codec": CODEC, "leaves": [],
            **(extra_meta or {})}
    shard_idx, buf, size = 0, [], 0

    def flush():
        nonlocal shard_idx, buf, size
        if not buf:
            return
        with open(tmp / f"shard_{shard_idx:05d}.bin", "wb") as f:
            f.write(zlib.compress(b"".join(buf), 6))
        shard_idx, buf, size = shard_idx + 1, [], 0

    for path, leaf in leaves:
        leaf = torch.as_tensor(leaf)
        data = _to_bytes(leaf)
        meta["leaves"].append({"key": _key(path), "dtype": _dtype_name(leaf.dtype),
                               "shape": list(leaf.shape), "shard": shard_idx,
                               "offset": size, "nbytes": len(data)})
        buf.append(data)
        size += len(data)
        if size >= _CHUNK:
            flush()
    flush()
    with open(tmp / "meta.json", "w") as f:
        json.dump(meta, f)
    (tmp / "COMMIT").touch()
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if not p.name.endswith(".tmp"))
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest(ckpt_dir: str | os.PathLike) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        p for p in ckpt_dir.glob("step_*")
        if not p.name.endswith(".tmp") and (p / "COMMIT").exists()
    )
    return steps[-1] if steps else None


def restore(path: str | os.PathLike, target_tree) -> tuple[Any, dict]:
    """Load a committed checkpoint into the structure of ``target_tree``
    (tensors, fake tensors or anything with a ``shape``): full logical CPU
    tensors, each leaf's shape checked against the target's."""
    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    if meta.get("codec") != CODEC:
        raise ValueError(f"{path}: codec {meta.get('codec')!r} is not the port's "
                         f"(a checkpoint of the JAX package?)")
    shards: dict[int, bytes] = {}
    loaded = {}
    for item in meta["leaves"]:
        if item["shard"] not in shards:
            with open(path / f"shard_{item['shard']:05d}.bin", "rb") as f:
                shards[item["shard"]] = zlib.decompress(f.read())
        data = shards[item["shard"]][item["offset"]:item["offset"] + item["nbytes"]]
        loaded[item["key"]] = _from_bytes(data, item["dtype"], item["shape"])

    flat, treedef = tree_flatten_with_path(target_tree)
    out = []
    for pathk, ref in flat:
        key = _key(pathk)
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = loaded[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(arr.shape)} vs model "
                f"{tuple(ref.shape)}")
        out.append(arr)
    return tree_unflatten(treedef, out), meta
