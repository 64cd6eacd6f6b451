"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface: ``build/<name>-<hash>.so`` beside this file (the
directory is git-ignored).  The hash covers every source and header in
``csrc/`` and the flags, so an edited source is rebuilt and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.
Nothing is built at import time: the CPU tests import every module and have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}
# ptxas resource lines (registers, shared memory, spills) of each build of
# this process, by kernel source name.
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_hash()}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that have no current library,
    one ``nvcc`` process each, all started together.  Raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else names
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = "\n".join(line for line in out.splitlines() if "ptxas" in line or "spill" in line)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def checked_ptrs(op: str, *tensors) -> list[int]:
    """``data_ptr()`` of each tensor, after checking what the kernels assume:
    one CUDA device, one dtype (float32 or bfloat16), contiguous rows,
    16-byte aligned (the kernels load 16 bytes per thread)."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{op}: all inputs must share device and dtype, got {t.device}/{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: inputs must be 16-byte aligned")
    if first.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {first.dtype} not supported (float32, bfloat16)")
    return [t.data_ptr() for t in tensors]


_counters: dict = {}


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the kernels that merge their
    blocks' partials in the same launch (the last block to count itself done
    merges); each such launch leaves its counters zero again.  One buffer per
    device, grown on demand and shared by those kernels: calls on one device
    run on one stream at a time, as the engine's do."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def function(lib: str, name: str, argtypes: list) -> object:
    """The C function ``name`` of kernel library ``lib`` (built if needed),
    with ``argtypes`` declared and an int (cudaError_t) result."""
    key = (lib, name)
    with _lock:
        if key not in _functions:
            if lib not in _libs:
                _libs[lib] = ctypes.CDLL(str(build_all([lib])[lib]))
            fn = getattr(_libs[lib], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return _functions[key]
