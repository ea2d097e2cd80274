"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). Libraries
land in ``build/kernels/`` at the root of the checkout, named by a hash
of their sources and flags, so a changed source rebuilds and an
unchanged one is reused. The first call to ``library`` builds every
missing library at once, one ``nvcc`` process per source started
together.

Nothing here runs at import time: CPU-only installations (no ``nvcc``,
no card) import every kernel module and use the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("bgmv", "sgmv", "paged_attention", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Dtype codes shared with csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


# Kernel instances of sgmv and flash_attention, chosen by dtype and shape;
# the f32 instance of flash_attention and of its backward runs each f32
# product as three TF32 tensor-core products.
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
TF32X3 = "tf32x3"


class KernelStats:
    """Per-kernel counters: ``launches`` counts CUDA launches (added to
    only right after a successful launch), ``instances`` the same per
    kernel instance (flash_attention has three, sgmv and the flash
    backward two, the other kernels one), ``plain`` counts calls the
    wrapper served with its plain PyTorch version (CPU tensors)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0
        self.instances: dict[str, int] = {}

    def launched(self, instance: str) -> None:
        self.launches += 1
        self.instances[instance] = self.instances.get(instance, 0) + 1


def build_dir() -> Path:
    """``build/kernels`` under the checkout root (``src/..``)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all in parallel.

    Returns {name: seconds} for the libraries built by this call (empty
    when all were cached). Raises with the compiler's output when any
    build fails.
    """
    todo = [n for n in SOURCES if not _lib_path(n).is_file()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def ptxas_usage(name: str) -> list[dict]:
    """Registers, static shared memory, stack and spill bytes of every
    kernel in ``csrc/<name>.cu`` as ``nvcc -Xptxas=-v`` reported them
    when the library was built (empty if it was not built here)."""
    log = _lib_path(name).with_suffix(".log")
    if not log.is_file():
        return []
    usage, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            usage.append(cur)
        elif cur is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_static", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and usage:
        names = subprocess.run([filt], input="\n".join(u["kernel"]
                                                       for u in usage),
                               capture_output=True, text=True).stdout
        for u, n in zip(usage, names.splitlines()):
            u["kernel"] = n.replace("(anonymous namespace)::",
                                    "").split("(", 1)[0]
    return usage


def library(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (building on first
    use), with ``<name>_launch`` typed: pointers and the stream as
    ``c_void_p``, sizes as ``c_int``, returning the CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream on ``device`` as a raw pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def lora_splits(T: int, tile: int, rows_per_block: int, din: int,
                r: int) -> int:
    """How many blocks split din in the shrink kernel of csrc/lora.cuh
    (sgmv's CUDA-core instance): enough blocks for about two waves over
    the H100's 132 SMs, at least four rows of din per thread, at most
    64 splits. The wrapper allocates the (splits, T, r) f32 partial
    sums."""
    n_chunks = (T // tile) * -(-tile // rows_per_block)
    row_groups = 256 // r
    return max(1, min(din // (4 * row_groups), -(-264 // n_chunks), 64))


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    return code
