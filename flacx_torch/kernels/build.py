"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded by ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build happens at first use, into
``flacx_torch/_build/<hash of the sources and flags>/``, with one ``nvcc``
per source, all started together.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from flacx_torch import trace

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parents[1] / "_build"
KERNELS = ("analysis", "lpc_residual", "lpc_allorder", "rice_stats",
           "frame_pack", "bit_unpack", "reconstruct", "crc16_rows",
           "reference_analysis", "seqshard")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("flacx_torch: nvcc not found; the CUDA kernels are "
                       "built on the machine with the card")


def build_dir() -> Path:
    """Build directory keyed by the sources and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.

    Returns the seconds spent.  Raises with the compiler's output when a
    build fails.  ``nvcc``'s resource report (``-Xptxas -v``) is kept
    beside each library as ``<name>.log``.
    """
    t0 = time.perf_counter()
    with _lock:
        out = build_dir()
        todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
        if not todo:
            return time.perf_counter() - t0
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in jobs:
            log, _ = proc.communicate()
            (out / f"{name}.log").write_text(log)
            if proc.returncode:
                failed.append(f"--- {name} ---\n{log}")
                os.unlink(tmp)
            else:
                os.replace(tmp, out / f"lib{name}.so")
        if failed:
            raise RuntimeError("flacx_torch: kernel build failed\n"
                               + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all at first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        _libs[name] = lib
    return lib


@functools.cache
def bind(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """C function ``symbol`` of kernel ``name`` taking ``n_ptrs`` pointers,
    then ``n_ints`` ints, then the stream; returns a CUDA error code."""
    fn = getattr(library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(fn, tensors: list[torch.Tensor], ints: list[int],
           what: str) -> None:
    """Call a bound kernel launcher on the current stream; raise on a
    refused launch (the code is ``cudaGetLastError()`` after it).  A
    ``None`` in ``tensors`` passes a null pointer.  Each launch counts
    under ``launch.<what>`` (:mod:`flacx_torch.trace`)."""
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints,
            stream)
    if rc:
        raise RuntimeError(f"flacx_torch: {what} launch failed with CUDA "
                           f"error {rc}")
    trace.count("launch." + what)


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None,
          ) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` where given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
