"""The port's CUDA glue, shared by every kernel module.

- **The device switch.** Entry points run on ``cuda`` unless
  ``set_device("cpu")`` selects the plain PyTorch versions (the tests).
  With ``cuda`` selected and no card, ``require_device`` raises: nothing
  carries on quietly on the CPU.
- **The build.** Each ``csrc/*.cu`` is compiled (sm_90a) into its own
  shared library in the git-ignored ``build/torch_kernels/``, named by
  the hash of its source, the ``csrc/*.cuh`` headers and the flags (a
  stale library is never loaded),
  at first use: one nvcc process per source, all started together. The
  libraries are bound with ctypes. Every entry has a plain C interface
  and returns the ``cudaError_t`` of its launch.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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


def device_names() -> list:
    """The devices the port runs on, by name: each card's
    ``torch.cuda.get_device_name`` under the CUDA switch (raising, as
    ``require_device`` does, when there is none), ``["cpu"]`` under the
    CPU switch."""
    if require_device("the device list").type == "cpu":
        return ["cpu"]
    return [torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]


# ---- build and load ---------------------------------------------------------

_LIB_LOCK = threading.Lock()
_LIBS: Optional[list] = None
_LIB_ERROR: Optional[str] = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable("nvcc not found (PATH or $CUDA_HOME/bin)")


def build() -> list:
    """Compile each csrc/*.cu into its own library under BUILD_DIR
    (build/torch_kernels/ unless util/devicewatch.enable_compile_cache
    points it elsewhere; the file name carries the hash of the source,
    the headers and the flags), one nvcc process per source, all started
    together; a library already there is reused. Returns the library
    paths; raises KernelUnavailable."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    # the headers every source may include take part in each hash
    shared = b""
    for hdr in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            shared += f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    outs, procs = {}, {}
    t0 = time.monotonic()
    for src in srcs:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(shared)
        with open(src, "rb") as f:
            h.update(f.read())
        stem = os.path.splitext(os.path.basename(src))[0]
        out = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
        outs[src] = out
        if not os.path.exists(out):
            cmd = [nvcc, *NVCC_FLAGS, "-o", f"{out}.{os.getpid()}.tmp", src]
            procs[src] = (cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = [], []
    for src, (cmd, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += "\nnvcc timed out after 900 s"
        logs.append(f"$ {' '.join(cmd)}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}): "
                          f"{log[-2000:]}")
        else:
            os.replace(f"{outs[src]}.{os.getpid()}.tmp", outs[src])
    BUILD_INFO.update(libraries=dict(outs), cached=not procs,
                      reused=len(outs) - len(procs),
                      seconds=time.monotonic() - t0, log="\n".join(logs))
    if failed:
        raise KernelUnavailable("nvcc failed: " + "; ".join(failed))
    return list(outs.values())


def kernel_libs() -> list:
    """Build (once per process) and load the kernel libraries. A failure
    is remembered and raised again on every later call."""
    global _LIBS, _LIB_ERROR
    with _LIB_LOCK:
        if _LIBS is not None:
            return _LIBS
        if _LIB_ERROR is not None:
            raise KernelUnavailable(_LIB_ERROR)
        try:
            libs = [ctypes.CDLL(path) for path in build()]
        except (KernelUnavailable, OSError, subprocess.SubprocessError) as e:
            _LIB_ERROR = f"{type(e).__name__}: {e}"
            raise KernelUnavailable(_LIB_ERROR) from e
        _LIBS = libs
        return libs


# the typed entries already looked up: (name, argtypes) -> function
_ENTRIES: dict = {}


def entry(name: str, argtypes: list):
    """The C entry ``name`` of the kernel libraries, typed: ``argtypes``
    as ctypes types (c_void_p for every pointer and the stream), returning
    the launch's cudaError_t as an int. Looked up once for each typing and
    kept (a lookup walks the libraries, each miss a failed dlsym)."""
    key = (name, tuple(argtypes))
    fn = _ENTRIES.get(key)
    if fn is not None:
        return fn
    for lib in kernel_libs():
        if hasattr(lib, name):
            # a function object of its own, so that each typing keeps its
            # argtypes
            fn = lib[name]
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _ENTRIES[key] = fn
            return fn
    raise KernelUnavailable(f"no kernel library has the entry {name}")


def launch(name: str, argtypes: list, dev: torch.device, *args) -> None:
    """Call the C entry ``name`` (typed by ``argtypes``) with ``args`` and
    the current stream of ``dev``; raise KernelUnavailable if its launch
    failed."""
    fn = entry(name, argtypes)
    check_launch(name, fn(*args, torch.cuda.current_stream(dev).cuda_stream))


def check_launch(name: str, rc: int) -> None:
    """Raise KernelUnavailable when a C entry returned a CUDA error."""
    if rc != 0:
        fn = entry("cuda_error_string", [ctypes.c_int])
        fn.restype = ctypes.c_char_p
        msg = fn(rc).decode()
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
