"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` with a plain C interface, and the
objects are linked into one shared library loaded with ``ctypes``. This
takes seconds, where a build against PyTorch's headers takes minutes.
The library goes to ``build/repro_torch/<hash>/`` under the checkout,
keyed on a hash of the sources, the headers they include (``*.cuh``)
and the flags, so a changed source or header rebuilds
and an unchanged one loads what is there. The build runs at first use,
never at import; a failed build raises. Processes that start on a cold
build directory together (the agents of a process-mode federation) take
an advisory file lock around the check and the compile: the first
builds, the others wait and load its library.
"""
from __future__ import annotations

import ctypes
import fcntl
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
# version does; the selective scan asks for its one approximate
# instruction, `ex2.approx.ftz.f32`, by name
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# the device types of a trace's fake mesh positions (``launch/dryrun.py``:
# a device index is a signed byte, so 256 positions a type): a tensor on
# one has no data, and each wrapper takes its trace route for it
TRACE_TYPES = ("meta", "lazy")


def traced(t) -> bool:
    """Is ``t`` on a trace's fake device (its wrapper's trace route)?"""
    return t.device.type in TRACE_TYPES


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
    """The sources compiled, one object each."""
    return sorted(CSRC.glob("*.cu"))


def inputs(csrc: Path = CSRC) -> List[Path]:
    """Every file the build reads: the sources and their headers."""
    return sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])


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
    out_dir = BUILD_ROOT / _digest(inputs())
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when closed
        if not lib.exists():                 # another process built it
            _compile(nvcc, srcs, lib)
    return lib


def _compile(nvcc: str, srcs: List[Path], lib: Path) -> None:
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
        lib.parent.mkdir(parents=True, exist_ok=True)
        # atomic: a reader that takes no lock sees no library or a whole
        # one
        os.replace(tmp_lib, lib)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded, with its entry points typed."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention_lse.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
    lib.repro_flash_attention_lse.restype = i
    lib.repro_quantize_int8.argtypes = [
        p, p, p, ctypes.c_int64, i, i, p]
    lib.repro_quantize_int8.restype = i
    lib.repro_quantize_int8_variant.argtypes = [p, i, i]
    lib.repro_quantize_int8_variant.restype = i
    lib.repro_quantize_int8_floor.argtypes = [
        p, p, ctypes.c_int64, i, i, p]
    lib.repro_quantize_int8_floor.restype = i
    lib.repro_flash_attention_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
    lib.repro_flash_attention_bwd.restype = i
    lib.repro_flash_attention_bwd_mma.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
    lib.repro_flash_attention_bwd_mma.restype = i
    lib.repro_flash_attention_variant.argtypes = [p, p, p, i, i]
    lib.repro_flash_attention_variant.restype = i
    lib.repro_moe_gmm.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.repro_moe_gmm.restype = i
    lib.repro_moe_gmm_plan.argtypes = [
        i, i, i, i, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.repro_moe_gmm_plan.restype = i
    lib.repro_rwkv6_wkv.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.repro_rwkv6_wkv.restype = i
    lib.repro_rwkv6_wkv_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.repro_rwkv6_wkv_bwd.restype = i
    lib.repro_selective_scan.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_selective_scan.restype = i
    lib.repro_selective_scan_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_selective_scan_bwd.restype = i
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with "
                           f"cudaError_t {err}")
