"""Build and load the port's CUDA kernels (`mxnet_tpu_torch/csrc/*.cu`).

Every source is compiled by its own `nvcc` process for `sm_90a`, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The library lands in `mxnet_tpu_torch/build/<key>/`,
where the key hashes the sources and the flags: the first call that
launches a kernel builds it, later processes find it. A failed build
raises with the compiler's output.

Each kernel is a :class:`CudaKernel`: a C entry point plus a plain
integer count of its launches. An entry point returns 0 or a CUDA status
(`cudaGetLastError()` right after the launch); any other value raises.
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

__all__ = ["CudaKernel", "load_library", "library_path", "launch_counts",
           "reset_launch_counts", "dtype_code", "check_cuda_tensor",
           "stream_handle"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libmxtt_kernels.so"

#: every kernel of the library by C symbol (see launch_counts)
KERNELS: dict = {}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from mxnet_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def _build(lib: Path):
    nvcc = _nvcc()
    tmp = lib.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        cu = [p for p in _sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        failed = []
        for src, p in zip(cu, procs):
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"--- {src.name} (exit {p.returncode})\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)   # atomic: readers never see a partial file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            lib = library_path()
            if not lib.exists():
                _build(lib)
            _lib = ctypes.CDLL(str(lib))
            _lib.mxtt_error_string.argtypes = [ctypes.c_int]
            _lib.mxtt_error_string.restype = ctypes.c_char_p
        return _lib


class CudaKernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    def __call__(self, *args):
        fn = self._fn
        if fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = fn(*args)
        if rc:
            msg = load_library().mxtt_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: {msg} "
                               f"(status {rc})")
        self.launches += 1


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODES[t.dtype]


def check_cuda_tensor(t: torch.Tensor, name: str, device: torch.device,
                      dtypes=tuple(_DTYPE_CODES), ndim: int = None,
                      align16: bool = False):
    """Raise unless `t` is a contiguous tensor on `device` of one of
    `dtypes` (of rank `ndim`; starting on a 16-byte boundary if
    `align16`, for kernels that load 16 bytes at a time): what a kernel
    does not take is an error on the card, never a silent detour."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{', '.join(map(str, dtypes))}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
