"""The port's CUDA glue, shared by every kernel module.

- **The device switch.** Entry points run on ``cuda`` unless
  ``set_device("cpu")`` selects the plain PyTorch versions (the tests).
  With ``cuda`` selected and no card, ``require_device`` raises: nothing
  carries on quietly on the CPU.
- **The build.** Every ``csrc/*.cu`` is compiled by ONE nvcc call (sm_90a)
  into ONE shared library in the git-ignored ``build/torch_kernels/``,
  named by the hash of the sources and flags (a stale library is never
  loaded), at first use, and bound with ctypes. Every entry has a plain C
  interface and returns the ``cudaError_t`` of its launch.
- **Fault classification.** A kernel that cannot be built, loaded or
  launched raises ``KernelUnavailable``; so does a CUDA runtime error that
  torch reports (``raise_kernel_fault``). Supervised dispatch re-raises
  both: a missing or broken kernel is never degraded to the CPU engine.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
# --threads 0: nvcc compiles the sources in parallel, one thread a CPU
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--threads", "0"]


class KernelUnavailable(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched, or failed on
    the card. Supervised dispatch re-raises it: a missing or broken kernel
    is never degraded to the CPU."""


# ---- device switch ----------------------------------------------------------

_DEVICE: Optional[torch.device] = None  # set_device() override; None = cuda


def set_device(dev) -> torch.device:
    """Select the device the kernels run on: ``"cuda"`` (the default) or
    ``"cpu"`` (the plain PyTorch versions — the tests)."""
    global _DEVICE
    d = torch.device(dev)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (cuda or cpu)")
    _DEVICE = d
    return d


def device() -> torch.device:
    return _DEVICE if _DEVICE is not None else torch.device("cuda")


def require_device(what: str) -> torch.device:
    """The device leg's entry check: CUDA selected with no card raises —
    it never carries on quietly on the CPU."""
    d = device()
    if d.type == "cuda" and not torch.cuda.is_available():
        raise KernelUnavailable(
            f"{what} needs CUDA, and torch.cuda.is_available() is False "
            "(select set_device('cpu') for the plain version)")
    return d


# ---- build and load ---------------------------------------------------------

_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_ERROR: Optional[str] = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable("nvcc not found (PATH or $CUDA_HOME/bin)")


def build() -> str:
    """Compile every csrc/*.cu in one nvcc call into one library under
    build/torch_kernels/ (the file name carries the hash of the sources
    and flags). Returns the library path; raises KernelUnavailable."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")
    BUILD_INFO["library"] = out
    if os.path.exists(out):
        BUILD_INFO["cached"] = True
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_INFO.update(seconds=time.monotonic() - t0, cached=False,
                      command=" ".join(cmd),
                      log=(proc.stdout + proc.stderr)[-16000:])
    if proc.returncode != 0:
        raise KernelUnavailable(
            f"nvcc failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def kernel_lib() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library. A failure is
    remembered and raised again on every later call."""
    global _LIB, _LIB_ERROR
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERROR is not None:
            raise KernelUnavailable(_LIB_ERROR)
        try:
            lib = ctypes.CDLL(build())
        except (KernelUnavailable, OSError, subprocess.SubprocessError) as e:
            _LIB_ERROR = f"{type(e).__name__}: {e}"
            raise KernelUnavailable(_LIB_ERROR) from e
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def entry(name: str, argtypes: list):
    """The C entry ``name`` of the kernel library, typed: ``argtypes`` as
    ctypes types (c_void_p for every pointer and the stream), returning
    the launch's cudaError_t as an int."""
    fn = getattr(kernel_lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise KernelUnavailable when a C entry returned a CUDA error."""
    if rc != 0:
        msg = kernel_lib().cuda_error_string(rc).decode()
        raise KernelUnavailable(f"{name} launch failed: {msg}")


def raise_kernel_fault(err: BaseException, what: str) -> None:
    """Raise KernelUnavailable when ``err`` is a CUDA runtime error that
    torch reported (an illegal address or a failed launch in a kernel: the
    context is lost, and a broken kernel must surface rather than hide
    behind a breaker's CPU fallback). Any other error returns, to be
    supervised as a transient device fault."""
    accel = getattr(torch, "AcceleratorError", None)
    if (accel is not None and isinstance(err, accel)) or (
            isinstance(err, RuntimeError) and "CUDA error" in str(err)):
        raise KernelUnavailable(f"{what} failed on the card: {err}") from err
