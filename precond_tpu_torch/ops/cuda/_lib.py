"""Build and load the port's hand-written CUDA kernels.

Route: every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), linked into one shared library with a plain C
interface, and loaded with ctypes. The library lands in ``build/kernels/``
at the repo root under a name keyed by the sources' content hash, so an
edited source rebuilds and an unchanged one loads the cached file. Nothing
is built when this module is imported: the first kernel call builds.

Each C entry launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; `launch` turns a nonzero code into an
error and counts the launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds": float, "cached": bool, "log": str, "path": str}
build_info: dict = {}
#: kernel launches per wrapper; a wrapper adds one where it launches, and
#: nowhere else (a run can show that the main path went through a kernel)
launch_counts = {"spd_inverse96": 0, "packed_symv96": 0, "symv96": 0, "symv96_bf16": 0,
                 "stencil_spmv": 0, "ell_spmv": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_VP, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: argtypes (pointers, sizes, stream); every entry returns cudaError_t
    "spd_inverse96": (_VP, _VP, _I, _I, _VP),   # a, out, nb, repair, stream
    "packed_symv96": (_VP, _VP, _VP, _VP, _I, _VP),
    "symv96": (_VP, _VP, _VP, _I, _VP),
    "symv96_bf16": (_VP, _VP, _VP, _I, _VP),    # bf16 table, f32 rhs and z
    # no launch: K3-bf16's persistent grid and its blocks per SM (out int*);
    # symv96_bf16 sizes its grid itself, from the SM count and the occupancy
    "symv96_bf16_grid": (_IP, _IP),
    # diag, dirs, x, y, nx, ny, nd, host int[2*nd] offsets, stream
    "stencil_spmv": (_VP, _VP, _VP, _VP, _I, _I, _I, _IP, _VP),
    # diag, idx, blocks, mask, x, y, n, k, stream
    "ell_spmv": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP),
    # no launch: K1's shared memory per block and blocks per SM (out int*)
    "spd_inverse96_occupancy": (_IP, _IP),
}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _build(target: str) -> str:
    """Compile every source in parallel, link `target`; returns the log."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp_so, *[o for _, o, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, target)  # atomic: concurrent builders never see half a file
    with open(target + ".log", "w") as f:
        f.write(log)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for src in _sources():
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + b"\0" + f.read())
        for flag in NVCC_FLAGS:
            h.update(flag.encode())
        target = os.path.join(BUILD_DIR, f"libprecond_kernels_{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        cached = os.path.exists(target)
        log = _build(target) if not cached else ""
        if cached and os.path.exists(target + ".log"):
            with open(target + ".log") as f:
                log = f.read()
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, cached=cached, log=log, path=target)
        _lib = lib
        return lib


def check_operand(name: str, t, shape, what: str, device, dtype=None) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` (default f32) and
    `shape` on CUDA `device`."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: {what} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def launch(name: str, device, *args) -> None:
    """Call C entry `name` on `device`'s current stream; raise on a nonzero
    cudaError_t (a refused launch never runs, and no later synchronize
    reports it).

    The stream comes from torch's raw getter, and the device is switched
    only when it is not the current one: ``torch.cuda.current_stream(...)``
    and ``torch.cuda.device(...)`` cost more host time than a small launch
    takes on the card (PERF.md §6)."""
    import torch

    lib = load()
    index = device.index
    if index == torch.cuda.current_device():
        code = getattr(lib, name)(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = getattr(lib, name)(*args, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {code}")
    launch_counts[name] += 1
