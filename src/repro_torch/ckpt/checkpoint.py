"""Checkpointing: one file a leaf, CRC checksums, atomic publish, resume.

The port of the JAX package's ``ckpt/checkpoint.py``, with its layout, so
either package restores what the other saves:

    <dir>/step_<N>/
        manifest.json   {"step": N, "leaves": {file: {key, shape, dtype,
                                                      crc32, bytes}}}
        <key>.npy       one file per leaf; keys are the tree's path joined
                        by "::" (e.g. "params::embed")

* atomic publish — a save writes ``step_N.tmp`` and renames it, so a crash
  never shadows the latest good step;
* corruption detection — each leaf file's CRC32 is checked at restore, and
  a step that fails is skipped for the one before it;
* restore onto a mesh — leaves are stored whole, and ``reshard`` places
  them on the mesh's device (the port's parameters are not sharded).

numpy has no bfloat16: a bfloat16 leaf is stored as its raw 16-bit
pattern, a 2-byte void array, which is what ``np.save`` writes for the JAX
package's ml_dtypes bfloat16 arrays too, with ``"dtype": "bfloat16"`` in
the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

SEP = "::"

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{"a::b": leaf} in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    return {prefix[:-len(SEP)]: tree}


def _unflatten_like(template: Any, flat: dict[str, Any],
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}{SEP}")
                for k, v in template.items()}
    return flat[prefix[:-len(SEP)]]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array to write: bfloat16 as its 16-bit pattern."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _to_host(state: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {k: (arr, _dtype_name(v, arr))
            for k, v in _flatten(state).items() for arr in (_to_numpy(v),)}


def _write(host: dict[str, tuple[np.ndarray, str]], ckpt_dir: str,
           step: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for key, (arr, dtype) in host.items():
        fn = key.replace("/", "_") + ".npy"
        p = os.path.join(tmp, fn)
        np.save(p, arr)
        with open(p, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest[fn] = {"key": key, "shape": list(arr.shape),
                        "dtype": dtype, "crc32": crc,
                        "bytes": int(arr.nbytes)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(state: Any, ckpt_dir: str, step: int) -> str:
    """Synchronous atomic save of a tree of tensors (or arrays).  Returns
    the published directory."""
    return _write(_to_host(state), ckpt_dir, step)


class AsyncSaver:
    """Overlap checkpoint writes with the next train steps: the copy to
    the host on the caller, the file I/O on a worker thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, state: Any, ckpt_dir: str, step: int):
        host = _to_host(state)
        self.wait()
        self._thread = threading.Thread(
            target=_write, args=(host, ckpt_dir, step), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _verify(step_dir: str) -> Optional[dict]:
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for fn, info in manifest["leaves"].items():
            with open(os.path.join(step_dir, fn), "rb") as f:
                if zlib.crc32(f.read()) != info["crc32"]:
                    return None
        return manifest
    except Exception:
        return None


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def _load_leaf(path: str, info: dict, device) -> torch.Tensor:
    arr = np.load(path)
    if info["dtype"] in _TORCH_DTYPES:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(_TORCH_DTYPES[info["dtype"]]).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def restore_latest(ckpt_dir: str, template: Any, *, specs: Any = None,
                   mesh=None) -> tuple[Optional[Any], Optional[int]]:
    """Restore the newest step whose checksums verify, skipping corrupt
    ones -> (state, step), or (None, None).  Leaves come back as tensors
    with the saved dtypes, on the device of the template's leaf (the CPU
    where the template holds none), or with (specs, mesh) placed by
    ``reshard``."""
    flat_t = _flatten(template)
    for step in reversed(list_steps(ckpt_dir)):
        step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
        manifest = _verify(step_dir)
        if manifest is None:
            continue
        flat = {}
        for fn, info in manifest["leaves"].items():
            like = flat_t.get(info["key"])
            device = like.device if torch.is_tensor(like) else "cpu"
            flat[info["key"]] = _load_leaf(os.path.join(step_dir, fn), info,
                                           device)
        state = _unflatten_like(template, flat)
        if mesh is not None and specs is not None:
            state = reshard(state, specs, mesh)
        return state, step
    return None, None


def reshard(state: Any, specs: Any, mesh) -> Any:
    """Every leaf on the mesh's device.  The port's parameters are not
    sharded, so each leaf's spec resolves to a whole copy on the mesh's
    first device (its "data" x "model" slots share it)."""
    device = mesh.devices.reshape(-1)[0]
    flat_specs = _flatten(specs)
    missing = [k for k in _flatten(state) if k not in flat_specs]
    if missing:
        raise ValueError(f"reshard: no spec for {missing[:3]}")
    return _unflatten_like(state, {k: v.to(device)
                                   for k, v in _flatten(state).items()})
