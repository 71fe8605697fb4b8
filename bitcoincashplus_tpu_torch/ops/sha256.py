"""Batched SHA-256 / SHA-256d: the round arithmetic, the batch header
hash (K1) and the word helpers of the nonce sweeps.

Port of the reference's ops/sha256.py:

- **The round arithmetic** (``_add``, ``_rotr``, the sigmas, ``_round``)
  on Python ints and on int64 tensors holding 32-bit values (the port's
  plain form: CPU torch has no uint32 shifts, adds or compares), masked
  after every add. The sweeps (ops/sha256_sweep.py) build on it too.
- **The plain versions** ``compress``, ``sha256_of_state``, ``sha256d_64``
  and ``sha256d_80``: lists of such values in and out, as the reference's
  (big-endian 32-bit words, SHA-256's own view).
- **The kernels** (``csrc/sha256d_batch.cu``, CUDA C++ for sm_90a, built
  and bound by ops/cuda_build.py): ``sha256d_headers_words`` replaces the
  XLA program ``sha256d_headers_jit`` (K1), ``check_headers_pow_words``
  replaces ``check_headers_pow_jit`` (the same digest plus the ``le256``
  compare). Each takes the plain version only for a tensor on the CPU; for
  a CUDA tensor it launches the kernel or raises ``KernelUnavailable`` —
  it never falls back.
- **The host API** ``sha256d_headers``: (B, 80) uint8 headers -> (B, 32)
  uint8 digests, supervised at the ``sha256`` site with the reference's
  lane-0 host check and poison (consensus/pow.check_headers_pow_batch).

Conventions: digest "limbs" are the hash as a little-endian uint256
(the arith_uint256 view of CheckProofOfWork): limb[j] = bswap32(h[j]).
Tensors the kernels read or write hold u32 words as int32 bit patterns.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..crypto.hashes import SHA256_INIT, SHA256_K
from . import cuda_build
from .cuda_build import KernelUnavailable, require_device

M32 = 0xFFFFFFFF
_K = SHA256_K
_IV = SHA256_INIT
_PAD = 0x80000000
_LEN_80B = 640
_LEN_64B = 512
_LEN_32B = 256


# ---- the SHA-256 round arithmetic (Python ints or int64 tensors) ------------

def _add(*xs):
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    return s & M32


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _S0(x):
    return _rotr(x, 2) ^ _rotr(x, 13) ^ _rotr(x, 22)


def _S1(x):
    return _rotr(x, 6) ^ _rotr(x, 11) ^ _rotr(x, 25)


def _s0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _s1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _ch(e, f, g):
    return g ^ (e & (f ^ g))


def _maj(a, b, c):
    return ((b ^ c) & a) ^ (b & c)


def _round(state, k, w):
    a, b, c, d, e, f, g, h = state
    t1 = _add(h, _S1(e), _ch(e, f, g), k, w)
    t2 = _add(_S0(a), _maj(a, b, c))
    return (_add(t1, t2), a, b, c, _add(d, t1), e, f, g)


def bswap32(x):
    """Byte-swap each 32-bit value (wire LE <-> SHA BE word views)."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


# ---- the plain versions (lists of 32-bit values) ----------------------------

def compress(state8: list, w16: list) -> list:
    """One SHA-256 compression — CSHA256::Transform
    (src/crypto/sha256.cpp:~40): 8 state words and 16 message words in
    (Python ints or int64 tensors, broadcastable), the new state out."""
    w = list(w16)
    st = tuple(state8)
    for i in range(64):
        if i >= 16:
            w.append(_add(w[i - 16], _s0(w[i - 15]), w[i - 7],
                          _s1(w[i - 2])))
        st = _round(st, _K[i], w[i])
    return [_add(s, o) for s, o in zip(state8, st)]


def sha256_of_state(h8: list) -> list:
    """SHA-256 of a 32-byte digest held as 8 state words — the second hash
    of every double-SHA: one padded block, msg || 0x80 || len=256."""
    return compress(list(_IV), list(h8) + [_PAD] + [0] * 6 + [_LEN_32B])


def sha256d_64(w16: list) -> list:
    """Double-SHA256 of a 64-byte message given as 16 BE words — the
    Merkle inner-node hash (src/consensus/merkle.cpp:~45): 3 compressions
    (message block, padding block, second hash)."""
    h = compress(list(_IV), w16)
    h = compress(h, [_PAD] + [0] * 14 + [_LEN_64B])
    return sha256_of_state(h)


def sha256d_80(w20: list) -> list:
    """Double-SHA256 of an 80-byte message given as 20 BE words —
    CBlockHeader::GetHash without midstate reuse."""
    h = compress(list(_IV), w20[:16])
    h = compress(h, list(w20[16:20]) + [_PAD] + [0] * 10 + [_LEN_80B])
    return sha256_of_state(h)


def header_sweep_digest(midstate8: list, tail3: list, nonces):
    """SHA-256d digests for a nonce sweep from a precomputed midstate —
    the reference's unhoisted form (the sweeps' hoisted arithmetic is
    ops/sha256_sweep.sweep_digest_hoisted; the tests hold the two equal).

    midstate8: the 8 SHA-256 state words after header bytes 0..63;
    tail3: the BE words of bytes 64..75 (merkle tail, nTime, nBits), as
    Python ints or int64 tensors; nonces: an int64 tensor of candidate
    nonces (host byte order: the header stores them LE, so the BE message
    word is bswap32(nonce)). Returns the 8 digest state words, each shaped
    like ``nonces``: 2 compressions a nonce."""
    w = [*tail3, bswap32(nonces), _PAD] + [0] * 10 + [_LEN_80B]
    return sha256_of_state(compress(list(midstate8), w))


def digest_to_limbs(h8: list) -> list:
    """Reinterpret digest state words as little-endian uint256 limbs
    (arith_uint256 view): limb[j] = bswap32(h[j]), limb 7 most significant."""
    return [bswap32(h) for h in h8]


def le256(limbs: list, target_limbs: list):
    """Branchless lexicographic hash <= target over LE limbs —
    CheckProofOfWork's arith_uint256 compare (src/pow.cpp:~74), evaluated
    per lane from the most significant limb down."""
    le = limbs[0] <= target_limbs[0]
    for j in range(1, 8):
        l, t = limbs[j], target_limbs[j]
        le = (l < t) | ((l == t) & le)
    return le


def words64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32) (the plain form)."""
    return t.to(torch.int64) & M32


def words32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns (the kernels' form)."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def sha256d_headers_plain(words: torch.Tensor) -> torch.Tensor:
    """The plain version of ``sha256d_headers_words``, on words' device."""
    w = words64(words)
    return words32(torch.stack(sha256d_80(list(w.unbind(1))), dim=1))


def check_headers_pow_plain(words: torch.Tensor, target: torch.Tensor):
    """The plain version of ``check_headers_pow_words``."""
    w = words64(words)
    h8 = sha256d_80(list(w.unbind(1)))
    ok = le256(digest_to_limbs(h8), list(words64(target).unbind()))
    return words32(torch.stack(h8, dim=1)), ok


# ---- host-side packing helpers (numpy) --------------------------------------

def target_to_limbs_np(target: int) -> np.ndarray:
    """256-bit target -> 8 LE uint32 limbs for the on-device compare."""
    return np.array(
        [(target >> (32 * j)) & 0xFFFFFFFF for j in range(8)], dtype=np.uint32
    )


def digests_to_bytes(h8) -> np.ndarray:
    """Device digest state (8 arrays shaped (...,)) -> (..., 32) uint8 wire
    digests (BE bytes per word, as SHA outputs)."""
    stacked = np.stack([np.asarray(h) for h in h8], axis=-1)  # (..., 8)
    return stacked.astype(">u4").view(np.uint8).reshape(*stacked.shape[:-1], 32)


def bytes_to_words_np(data: np.ndarray) -> np.ndarray:
    """(..., 4k) uint8 byte array -> (..., k) uint32 BE words."""
    if data.dtype != np.uint8 or data.shape[-1] % 4:
        raise ValueError(f"need (..., 4k) uint8 bytes, got {data.dtype} "
                         f"{data.shape}")
    return (
        data.reshape(*data.shape[:-1], data.shape[-1] // 4, 4)
        .view(">u4")  # big-endian words, SHA's native view
        .squeeze(-1)
        .astype(np.uint32)
    )


def headers_to_words_np(headers: np.ndarray) -> np.ndarray:
    """(B, 80) uint8 serialized headers -> (B, 20) uint32 BE words."""
    if headers.shape[-1] != 80:
        raise ValueError(f"headers are {headers.shape[-1]} bytes, not 80")
    return bytes_to_words_np(headers)


# ---- the kernel entries -----------------------------------------------------

# Launches per wrapper: each adds one where it launches its kernel, and
# nowhere else (the plain version does not count).
LAUNCHES = {"sha256d_headers": 0, "check_headers_pow": 0}

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
ENTRY_ARGS = {
    # (words, n, out, stream)
    "sha256d_headers": [_VP, _I64, _VP, _VP],
    # (words, n, target limbs, out, ok, stream)
    "check_headers_pow": [_VP, _I64, _VP, _VP, _VP, _VP],
}


def backend_is_cpu() -> bool:
    """True when the port's device switch selects the CPU
    (``cuda_build.set_device("cpu")``: the plain versions) — the
    reference's probe of the XLA CPU backend, which node/node.py reads to
    pick the mining engine (_select_sweep)."""
    return cuda_build.device().type == "cpu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_words(words: torch.Tensor, width: int, what: str) -> None:
    """A kernel's (N, width) int32 word input, contiguous and 16-byte
    aligned (the kernels read rows as 16-byte vectors)."""
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != width or not words.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous (N, {width}) int32 "
                         f"tensor, got {words.dtype} {tuple(words.shape)}")
    if words.device.type == "cuda" and words.data_ptr() % 16:
        raise ValueError(f"{what} is not 16-byte aligned")


def _launch(name: str, dev: torch.device, *args) -> None:
    cuda_build.launch(name, ENTRY_ARGS[name], dev, *args)
    LAUNCHES[name] += 1


def sha256d_headers_words(words: torch.Tensor) -> torch.Tensor:
    """(B, 20) int32 BE header words -> (B, 8) int32 digest state words
    (sha256d of each 80-byte header) on words' device — K1's contract (the
    reference's sha256d_headers_jit). Any B, not only the pow2 buckets."""
    check_words(words, 20, "header words")
    dev = words.device
    if dev.type == "cpu":
        return sha256d_headers_plain(words)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no header kernel for device {dev}")
    out = torch.empty((words.shape[0], 8), dtype=torch.int32, device=dev)
    if words.shape[0]:
        _launch("sha256d_headers", dev, words.data_ptr(), words.shape[0],
               out.data_ptr())
    return out


def check_headers_pow_words(words: torch.Tensor, target: torch.Tensor):
    """(B, 20) int32 header words + (8,) int32 LE target limbs ->
    ((B, 8) int32 digests, (B,) bool hash <= target) — the reference's
    check_headers_pow_jit."""
    check_words(words, 20, "header words")
    if (target.dtype != torch.int32 or tuple(target.shape) != (8,)
            or not target.is_contiguous() or target.device != words.device):
        raise ValueError("target limbs must be a contiguous (8,) int32 "
                         "tensor on the words' device")
    dev = words.device
    if dev.type == "cpu":
        return check_headers_pow_plain(words, target)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no header kernel for device {dev}")
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("check_headers_pow", dev, words.data_ptr(), n,
               target.data_ptr(), out.data_ptr(), ok.data_ptr())
    return out, ok


def sha256d_headers_cpu(headers: np.ndarray) -> np.ndarray:
    """Reference CPU engine for the batch header hash — the sha256 circuit
    breaker's fallback target (ops/dispatch)."""
    from ..crypto.hashes import sha256d

    return np.frombuffer(
        b"".join(sha256d(headers[i].tobytes())
                 for i in range(headers.shape[0])),
        dtype=np.uint8,
    ).reshape(-1, 32)


def sha256d_headers(headers: np.ndarray) -> np.ndarray:
    """Convenience host API: (B, 80) uint8 headers -> (B, 32) uint8 digests.

    Supervised (ops/dispatch): the device batch is spot-checked against the
    host hash of lane 0 before it is trusted; an injected fault or poison
    degrades to the per-header CPU loop without changing a single digest,
    and any other device failure raises KernelUnavailable. The device leg
    is watched (util/devicewatch): header batches legitimately vary in
    size, so the program carries NO shape budget — launches are counted
    and timed, never flagged."""
    from ..crypto.hashes import sha256d
    from ..util import devicewatch as dw
    from . import dispatch

    if headers.shape[0] == 0:
        return np.zeros((0, 32), dtype=np.uint8)

    def device() -> np.ndarray:
        words_np = headers_to_words_np(headers)
        dev = require_device("the header hash")
        dw.note_transfer("sha256", "h2d", int(words_np.nbytes))
        words = torch.from_numpy(words_np.view(np.int32)).to(dev)
        with dw.program("sha256_headers").dispatch(words_np.shape):
            h = sha256d_headers_words(words)
        t0 = time.perf_counter()
        h_np = h.cpu().numpy().view(np.uint32)
        out = digests_to_bytes([h_np[:, i] for i in range(8)])
        dw.note_transfer("sha256", "d2h", int(out.nbytes),
                         seconds=time.perf_counter() - t0)
        return out

    def validate(digests: np.ndarray) -> bool:
        return digests[0].tobytes() == sha256d(headers[0].tobytes())

    out, _ = dispatch.supervised_call(
        "sha256", device, lambda: sha256d_headers_cpu(headers),
        validate=validate,
        poison=lambda d: np.bitwise_xor(d, np.uint8(0xFF)),
        items=int(headers.shape[0]),
    )
    return out
