"""The SHA-256 core of the batch kernels (bitcoincashplus_tpu_torch/csrc/
sha256_core.cuh, the compression of csrc/sha256d_batch.cu) compiled for
the host with g++ and held against hashlib: sha256d of 64-byte rows (the
tree's and the pair hash's unit, the chain step) and of 80-byte headers
(K1's), over families of words that take the adds' carries and the
rotations through their edges.

The header is CUDA C++ written to compile for the host as well: the test
defines the few CUDA qualifiers, so the arithmetic that runs on the card
(the folded constant words, the two passes over one copy of the
compression) runs here. What only the card shows (the SASS, the pipes,
the time) is chip_smoke.py's.

Tolerance: exact equality (integer hashing)."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bitcoincashplus_tpu_torch", "csrc")

SHIM = r"""
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#include "sha256_core.cuh"
extern "C" void core_sha256d_64(const uint32_t* rows, long n, uint32_t* out) {
    for (long i = 0; i < n; ++i) {
        uint32_t w[16];
        std::memcpy(w, rows + 16 * i, sizeof w);
        sha256::sha256d_64(w, out + 8 * i);
    }
}
extern "C" void core_sha256d_80(const uint32_t* rows, long n, uint32_t* out) {
    for (long i = 0; i < n; ++i) {
        uint32_t w[16], tail[4];
        std::memcpy(w, rows + 20 * i, sizeof w);
        std::memcpy(tail, rows + 20 * i + 16, sizeof tail);
        sha256::sha256d_80(w, tail, out + 8 * i);
    }
}
"""

@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to compile the core for")
    d = tmp_path_factory.mktemp("sha256_core")
    src = d / "core.cpp"
    src.write_text(SHIM)
    out = d / "core.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    for name in ("core_sha256d_64", "core_sha256d_80"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        fn.restype = None
    return lib


def _run(fn, rows: np.ndarray) -> list:
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    out = np.zeros((rows.shape[0], 8), dtype=np.uint32)
    fn(rows.ctypes.data, rows.shape[0], out.ctypes.data)
    return [r.astype(">u4").tobytes() for r in out]


def _sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


# families of message words: uniform random; all zeros and all ones but one
# random word a row; the padding word 0x80000000 with random low bits; one
# bit a word, walking; and rows whose two halves are equal (the tree's
# self-pair and `mutated` rows)
FAMILIES = ("random", "zeros", "ones", "pad", "bits", "halves")


def _rows(n: int, width: int, family: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (n, width), dtype=np.uint64)
    idx = np.arange(n)
    if family in ("zeros", "ones"):
        keep = rows[idx, idx % width]
        rows[:] = 0 if family == "zeros" else 0xFFFFFFFF
        rows[idx, idx % width] = keep
    elif family == "pad":
        low = rng.integers(0, 2, (n, 1), dtype=np.uint64) * np.uint64(0xFF)
        rows = np.uint64(0x80000000) | (rows & low)
    elif family == "bits":
        rows = np.uint64(1) << ((idx[:, None] + np.arange(width)) % 32).astype(
            np.uint64)
    elif family == "halves":
        rows[:, 8:16] = rows[:, 0:8]
    rows[0] = 0
    rows[1] = 0xFFFFFFFF
    return rows.astype(np.uint32)


@pytest.mark.parametrize("family", FAMILIES)
def test_core_sha256d_64_equals_hashlib(core, family):
    rows = _rows(256, 16, family, 64)
    want = [_sha256d(r.astype(">u4").tobytes()) for r in rows]
    assert _run(core.core_sha256d_64, rows) == want


@pytest.mark.parametrize("family", FAMILIES[:5])
def test_core_sha256d_80_equals_hashlib(core, family):
    genesis = bytes.fromhex(
        "0100000000000000000000000000000000000000000000000000000000000000"
        "000000003ba3edfd7a7b12b27ac72c3e67768f617fc81bc3888a51323a9fb8aa"
        "4b1e5e4a29ab5f49ffff001d1dac2b7c")
    rows = _rows(256, 20, family, 80)
    rows[3] = np.frombuffer(genesis, dtype=">u4")
    want = [_sha256d(r.astype(">u4").tobytes()) for r in rows]
    got = _run(core.core_sha256d_80, rows)
    assert got == want
    assert got[3][::-1].hex() == ("000000000019d6689c085ae165831e934ff763ae"
                                  "46a2a6c172b3f1b60a8ce26f")


@pytest.mark.parametrize("start", [bytes(range(32)), bytes(32), b"\xff" * 32,
                                   b"\x80" + bytes(31)],
                         ids=["ramp", "zeros", "ones", "pad"])
def test_core_chain_equals_hashlib(core, start):
    """The chain step of the sha256d_chain entry: x = sha256d(x || x)."""
    x = want = start
    for _ in range(64):
        want = _sha256d(want + want)
    for _ in range(64):
        x = _run(core.core_sha256d_64, np.frombuffer(x + x, dtype=">u4")[None])[0]
    assert x == want
