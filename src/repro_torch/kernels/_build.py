"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` with a plain C interface, and the
objects are linked into one shared library loaded with ``ctypes``. This
takes seconds, where a build against PyTorch's headers takes minutes.
The library goes to ``build/repro_torch/<hash>/`` under the checkout,
keyed on a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads what is there. The build runs at first use,
never at import; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
# no --use_fast_math: quantize_int8 needs an IEEE division to agree
# with the reference bit for bit, attention an accurate expf, and the
# WKV recurrence keeps denormals (fast math flushes them) as its plain
# version does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class LaunchCounter:
    """Count of one kernel's launches; a wrapper adds one where it
    launches its kernel and nowhere else. Thread-safe: in thread mode
    every party of a federation calls the kernels from its own thread."""

    def __init__(self) -> None:
        self._n = 0
        self._mu = threading.Lock()

    def add(self) -> None:
        with self._mu:
            self._n += 1

    def reset(self) -> None:
        with self._mu:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first use and need the CUDA toolkit")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact source set has no library yet;
    return the library's path."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n"
                               f"{res.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        # atomic: a concurrent builder sees no library or a whole one
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.repro_flash_attention.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
            lib.repro_flash_attention.restype = i
            lib.repro_quantize_int8.argtypes = [
                p, p, p, ctypes.c_int64, i, i, p]
            lib.repro_quantize_int8.restype = i
            lib.repro_moe_gmm.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.repro_moe_gmm.restype = i
            lib.repro_rwkv6_wkv.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.repro_rwkv6_wkv.restype = i
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with "
                           f"cudaError_t {err}")
