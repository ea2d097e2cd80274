"""Checkpointing in the JAX package's on-disk layout (PyTorch).

Port of ``src/repro/training/checkpoint.py``, same layout and format
version, so a checkpoint written by either package restores in the
other:

    <dir>/step_<N>/
        manifest.json      — step, leaf index {tree/path: file, shape,
                             dtype}, extra, format_version 1
        <leaf-hash>.npy    — one file per leaf (first 16 hex digits of
                             the md5 of "tree/path")

bfloat16: numpy has no bf16 type. The JAX package's ``np.save`` of an
``ml_dtypes`` bfloat16 array writes raw 2-byte records with the header
descr ``'<V2'`` (``np.load`` returns ``|V2``) and ``"dtype":
"bfloat16"`` in the manifest. The port writes the same bytes (the
tensor's bits as uint16 under a ``'<V2'`` header) and reads them back
through the manifest's dtype (view as int16, then as
``torch.bfloat16``), bit-exact both ways.

``AsyncCheckpointer`` moves file IO off the step path. The port
updates params in place (``optimizer.adamw_update``), where JAX hands
immutable arrays to its thread, so ``save()`` copies every leaf to host
memory before it returns; only the file writes run on the worker
thread.

A state placed on a mesh (``ShardedTensor`` leaves) is saved as whole
arrays, gathered leaf by leaf, so its files are byte-identical to an
unsharded save of the same values. ``restore_checkpoint(shardings=)``
places each leaf that has a ``NamedSharding`` onto its mesh, as JAX's
``jax.make_array_from_callback`` does: save on one mesh, restore on
another (elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardedTensor

#: The header descr the JAX package's ``np.save`` writes for bfloat16.
BF16_DESCR = "<V2"


def _leaf_file(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()[:16] + ".npy"


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array that owns its memory: bf16 tensors as
    their uint16 bits, other tensors and arrays copied; a placed leaf
    gathered whole."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.cpu()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        arr = (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()
        return arr.view(np.uint16) if bf16 else arr
    return np.array(leaf, copy=True)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if (isinstance(leaf, (torch.Tensor, ShardedTensor))
            and leaf.dtype == torch.bfloat16):
        return "bfloat16"
    return str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _write(directory: str, step: int, host: dict, extra: dict | None
           ) -> str:
    """host: {tree: {path: (array, dtype name)}}."""
    out = os.path.join(directory, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index = {}
    for tree_name, tree in host.items():
        for path, (arr, dtype) in tree.items():
            key = f"{tree_name}/{path}"
            fname = _leaf_file(key)
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            index[key] = {"file": fname, "shape": list(arr.shape),
                          "dtype": dtype}
    manifest = {"step": step, "index": index, "extra": extra or {},
                "format_version": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)       # atomic publish
    return out


def _snapshot(trees: dict[str, dict]) -> dict:
    out = {}
    for name, tree in trees.items():
        out[name] = {}
        for k, v in tree.items():
            arr = _to_host(v)
            out[name][k] = (arr, _dtype_name(v, arr))
    return out


def save_checkpoint(directory: str, step: int, trees: dict[str, dict],
                    extra: dict | None = None) -> str:
    """trees: {"params": flat dict, "opt": flat dict, ...} of tensors
    (or arrays, or placed ``ShardedTensor`` leaves)."""
    return _write(directory, step, _snapshot(trees), extra)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: int | None = None,
                       shardings: dict[str, dict] | None = None,
                       device: torch.device | str | None = None,
                       ) -> tuple[int, dict[str, dict]]:
    """Returns (step, trees). ``shardings`` optionally maps tree/path ->
    ``NamedSharding``: such a leaf comes back placed on its mesh
    (``ShardedTensor``, each block a fresh tensor), every other leaf a
    tensor on ``device`` (the card unless the caller asks otherwise)."""
    if shardings is None:
        device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    trees: dict[str, dict] = {}
    for key, meta in manifest["index"].items():
        tree_name, path = key.split("/", 1)
        leaf = _load_leaf(os.path.join(src, meta["file"]), meta["dtype"])
        sh = (shardings or {}).get(tree_name, {}).get(path)
        if sh is not None:
            leaf = sh.shard(leaf, copy=True)
        else:
            leaf = leaf.to(resolve_device(device))
        trees.setdefault(tree_name, {})[path] = leaf
    return manifest["step"], trees


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Off-step-path checkpointing: every leaf is copied to host memory
    when ``save`` is called (so in-place updates after it cannot reach
    the checkpoint), file IO runs on a worker thread; ``wait()`` joins
    it before the next save or exit."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_path: str | None = None

    def save(self, step: int, trees: dict[str, dict],
             extra: dict | None = None) -> None:
        self.wait()
        host = _snapshot(trees)

        def work():
            try:
                self.last_path = _write(self.directory, step, host, extra)
                prune_checkpoints(self.directory, self.keep)
            except Exception as e:        # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending save; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
