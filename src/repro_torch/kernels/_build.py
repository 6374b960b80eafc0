"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``build/`` at
the repository root (listed in ``.gitignore``). :func:`build` starts one
``nvcc`` per source, all at once. Libraries are named by a hash of their
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.

:class:`Launcher` binds one C entry point with ``ctypes`` and counts its
launches: ``launches`` goes up by one exactly where the kernel is launched,
which is how a run shows that its main path went through the kernels.
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("multiport_sram", "kv_multiport", "kv_multiport_split",
           "kv_prefill_chunk", "flash_attention", "flash_attention_tc",
           "launch_floor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict = {}
LAUNCHERS: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc``
    process each, all started together. Returns {name: seconds} for the
    sources it compiled; the ptxas report of each lands beside its library
    as ``<name>.ptxas.txt``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class Launcher:
    """One C entry point of a kernel library and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None
        LAUNCHERS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        self.launches += 1
        rc = self._fn(*args)
        if rc != 0:
            msg = library(self.source).repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} ({msg})")


def launch_floor(device) -> None:
    """Launch the empty kernel of ``csrc/launch_floor.cu`` on ``device``'s
    current stream, through ctypes as every kernel is launched: the floor
    under each kernel's time. It is on no path and is not counted."""
    lib = library("launch_floor")
    lib.launch_floor.argtypes = [ctypes.c_void_p]
    lib.launch_floor.restype = ctypes.c_int
    rc = lib.launch_floor(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"launch_floor failed: CUDA error {rc} ({msg})")


def launch_counts() -> dict:
    """{C entry point: launches} for every kernel of the port."""
    return {k.symbol: k.launches for k in LAUNCHERS}


def reset_launch_counts() -> None:
    for k in LAUNCHERS:
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device (what the C interface takes)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
