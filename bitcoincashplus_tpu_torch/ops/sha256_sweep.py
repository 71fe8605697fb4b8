"""The truncated-h7 SHA-256d nonce sweep (the miner's candidate search).

Port of the reference's ops/sha256_sweep.py. Three layers:

- **The template hoist** (``hoist_template``): everything in the second
  compression of the first hash that does not depend on the nonce — the
  first three rounds, the K[i] + w[i] folds of the sweep-constant message
  words, the scalar legs of schedule words 16..32 — computed ONCE per
  template on the host (Python ints) and packed into a (64,) int32 tensor
  (``template_tensor``) on the sweep's device. The per-nonce remainder
  never recomputes it.
- **The kernel** (``csrc/sha256d_sweep.cu``, CUDA C++ for sm_90a, built
  and bound by ops/cuda_build.py). Its h7 sweep replaces both the Pallas
  kernel ``_sweep_kernel`` (K11, ops/pallas_sweep.py of the JAX package)
  and the XLA program ``sweep_fast_jit`` (K10, below); its exact sweep
  replaces ``ops/miner.sweep_jit`` (K12). The entry here is
  ``sweep_fast``, K10's contract: ``(found, nonce, tiles_done)``.
- **The plain version**: the same arithmetic in PyTorch on int64 tensors
  holding 32-bit values (CPU torch has no uint32 add, shift or compare),
  masked after every add. The tests run it on the CPU; ``chip_smoke.py``
  holds the kernel against it on the card.

A wrapper takes the plain version only for a template tensor on the CPU;
for a CUDA tensor it launches the kernel or raises ``KernelUnavailable``
— it never falls back.

The sweep is a candidate search: the top 32 bits of the little-endian
uint256 hash are bswap32(h[7]), and h[7] = IV7 + e_61, so the second
compression stops after round 60 and only its e-chain runs from round 57.
A candidate (limb 7 <= t7) is verified on the host against the full
target; a tie at limb 7 that fails is resumed past (``sweep_header_fast``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..crypto.hashes import SHA256_INIT, SHA256_K, header_midstate, sha256d
from . import cuda_build
from .cuda_build import KernelUnavailable, require_device
from .sha256 import (M32, _S0, _S1, _add, _ch, _maj, _round, _s0, _s1,
                     bswap32, bytes_to_words_np, target_to_limbs_np)

_K = SHA256_K
_IV = SHA256_INIT
_PAD = 0x80000000
_LEN80 = 640
_LEN32 = 256

# The packed template: (64,) int32 words (u32 bit patterns), this layout.
# csrc/sha256d_sweep.cu reads the same offsets.
T_MID, T_ST3, T_C3T1, T_T2_3, T_KW, T_SC, T_KWSC = 0, 8, 16, 17, 18, 30, 47
TEMPLATE_WORDS = 64
# schedule words whose scalar leg is identically zero (w5..w14 are zeros)
_SC_ZERO = frozenset((21, 28))

# Launches per wrapper (sweep_fast, ops/pallas_sweep.pallas_sweep,
# ops/miner.sweep): each adds one where it launches its kernel, and
# nowhere else (the plain version does not count).
LAUNCHES = {"sweep_h7": 0, "sweep_h7_pallas": 0, "sweep_exact": 0}

# nonces a step of the plain version hashes at once, per device type: it
# sweeps whole tiles in order and stops after the step holding the first
# hit, so a step is the granularity of its early exit (small on the CPU,
# where the tests' hits come early; large on the card, where each tensor
# operation is a launch)
PLAIN_STEP = {"cpu": 1 << 12, "cuda": 1 << 22}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- rounds with pre-folded constants (the rest is ops/sha256.py's) -------

def _round_kw(state, kw, vecw=None):
    """One round with the round constant pre-folded: ``kw`` is K[i] + the
    sweep-constant part of w[i]; ``vecw`` the nonce-dependent remainder
    (None for fully constant words)."""
    a, b, c, d, e, f, g, h = state
    t1 = _add(h, kw, _S1(e), _ch(e, f, g))
    if vecw is not None:
        t1 = _add(t1, vecw)
    t2 = _add(_S0(a), _maj(a, b, c))
    return (_add(t1, t2), a, b, c, _add(d, t1), e, f, g)


# chunk-3 (second hash) K+w folds for the padding rounds 8..15: w8 = PAD,
# w9..w14 = 0, w15 = LEN32
_KW3 = tuple(_add(_K[8 + i], w) for i, w in
             enumerate((_PAD, 0, 0, 0, 0, 0, 0, _LEN32)))
_S1_LEN32 = _s1(_LEN32)
_S0_PAD = _s0(_PAD)


# ---- the per-template hoist -------------------------------------------------

def hoist_template(midstate8, tail3) -> dict:
    """Everything in chunk 2 of the first hash that does not depend on the
    nonce (the reference's hoist_template, same keys). midstate8: the 8
    SHA-256 state words after header bytes 0..63; tail3: the 3 BE words of
    bytes 64..75 (merkle tail, nTime, nBits). Python ints in, ints out
    (numpy scalars are taken as ints)."""
    midstate8 = [int(m) for m in midstate8]
    w0, w1, w2 = (int(t) for t in tail3)
    st = tuple(midstate8)
    for i, w in enumerate((w0, w1, w2)):
        st = _round(st, _K[i], w)
    a3, b3, c3, d3, e3, f3, g3, h3 = st
    c3t1 = _add(h3, _S1(e3), _ch(e3, f3, g3), _K[3])
    t2_3 = _add(_S0(a3), _maj(a3, b3, c3))
    # rounds 4..15: the message words are PAD / zeros / LEN80
    w_const = [_PAD] + [0] * 10 + [_LEN80]
    kw = [_add(_K[4 + i], w) for i, w in enumerate(w_const)]
    sc = {}
    sc[16] = _add(w0, _s0(w1))
    sc[17] = _add(w1, _s0(w2), _s1(_LEN80))
    sc[18] = _add(w2, _s1(sc[16]))
    sc[19] = _add(_s0(_PAD), _s1(sc[17]))
    sc[20] = _PAD
    sc[22] = _LEN80
    sc[23] = sc[16]
    sc[24] = sc[17]
    sc[25] = sc[18]
    sc[26] = sc[19]
    sc[27] = sc[20]
    sc[29] = sc[22]
    sc[30] = _add(_s0(_LEN80), sc[23])
    sc[31] = _add(_LEN80, _s0(sc[16]), sc[24])
    sc[32] = _add(sc[16], _s0(sc[17]), sc[25])
    kwsc = {i: _add(_K[i], sc[i]) if i in sc else _K[i]
            for i in range(16, 33)}
    return {"mid": midstate8, "st3": st, "c3t1": c3t1, "t2_3": t2_3,
            "kw": kw, "sc": sc, "kwsc": kwsc}


def pack_template(pre: dict) -> list:
    """The hoisted template as TEMPLATE_WORDS u32 ints (module layout)."""
    words = [*pre["mid"], *pre["st3"], pre["c3t1"], pre["t2_3"], *pre["kw"]]
    words += [pre["sc"].get(i, 0) for i in range(16, 33)]
    words += [pre["kwsc"][i] for i in range(16, 33)]
    assert len(words) == TEMPLATE_WORDS
    return words


def u32_tensor(words, device) -> torch.Tensor:
    """u32 values (ints or numpy) -> int32 bit-pattern tensor on device."""
    a = np.asarray([int(w) & M32 for w in words], dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def template_tensor(midstate8, tail3, device) -> torch.Tensor:
    """The sweep's template on ``device`` from the midstate and tail words
    (the JAX package's inputs: numpy uint32 arrays, or ints)."""
    return u32_tensor(pack_template(hoist_template(midstate8, tail3)), device)


def header_template(header80: bytes, device) -> torch.Tensor:
    """The template of an 80-byte header (its nonce field is ignored)."""
    if len(header80) != 80:
        raise ValueError(f"header is {len(header80)} bytes, not 80")
    tail = bytes_to_words_np(np.frombuffer(header80[64:76], dtype=np.uint8))
    return template_tensor(header_midstate(header80), tail, device)


def unpack_template(tmpl: torch.Tensor) -> dict:
    """A (64,) template tensor -> the hoist dict of 0-d int64 tensors on
    its device (the plain version's form)."""
    w = list((tmpl.to(torch.int64) & M32).unbind())
    sc = {i: w[T_SC + i - 16] for i in range(16, 33) if i not in _SC_ZERO}
    return {"mid": w[T_MID:T_MID + 8], "st3": tuple(w[T_ST3:T_ST3 + 8]),
            "c3t1": w[T_C3T1], "t2_3": w[T_T2_3], "kw": w[T_KW:T_KW + 12],
            "sc": sc, "kwsc": {i: w[T_KWSC + i - 16] for i in range(16, 33)}}


# ---- the per-nonce remainder (plain version) --------------------------------

def _chunk2_digest_hoisted(pre, nonces):
    """First-hash digest words (8 values shaped like ``nonces``): chunk 2
    over [w0, w1, w2, nonce, PAD, 0*10, len] with every sweep-constant leg
    taken from ``pre``."""
    n = bswap32(nonces)
    sc = pre["sc"]
    vec = {18: _s0(n), 19: n}
    full = {16: sc[16], 17: sc[17]}

    def mat(i):
        w = full.get(i)
        if w is None:
            w = vec[i] if i in _SC_ZERO else _add(sc[i], vec[i])
            full[i] = w
        return w

    for i in range(20, 25):
        vec[i] = _s1(mat(i - 2))
    for i in range(25, 33):
        vec[i] = _add(vec[i - 7], _s1(mat(i - 2)))
    for i in range(33, 64):
        full[i] = _add(mat(i - 16), _s0(mat(i - 15)), mat(i - 7),
                       _s1(mat(i - 2)))

    a3, b3, c3, d3, e3, f3, g3, h3 = pre["st3"]
    t1 = _add(pre["c3t1"], n)
    st = (_add(t1, pre["t2_3"]), a3, b3, c3, _add(d3, t1), e3, f3, g3)
    for i in range(4, 16):
        st = _round_kw(st, pre["kw"][i - 4])
    for i in range(16, 33):
        st = _round_kw(st, pre["kwsc"][i], vec.get(i))
    for i in range(33, 64):
        st = _round(st, _K[i], full[i])
    return [_add(m, s) for m, s in zip(pre["mid"], st)]


def _chunk3_words(d8, upto: int) -> list:
    """Second-hash message schedule [d8 || PAD || 0*6 || len] up to word
    ``upto`` (constant legs folded; words 8..15 are never read)."""
    w = list(d8) + [None] * (upto - 8)
    w[16] = _add(w[0], _s0(w[1]))
    w[17] = _add(w[1], _s0(w[2]), _S1_LEN32)
    for i in range(18, 22):
        w[i] = _add(w[i - 16], _s0(w[i - 15]), _s1(w[i - 2]))
    w[22] = _add(w[6], _s0(w[7]), _LEN32, _s1(w[20]))
    w[23] = _add(w[7], _S0_PAD, w[16], _s1(w[21]))
    w[24] = _add(w[17], _s1(w[22]), _PAD)
    for i in range(25, 30):
        w[i] = _add(w[i - 7], _s1(w[i - 2]))
    w[30] = _add(w[23], _s1(w[28]), _s0(_LEN32))
    w[31] = _add(_LEN32, _s0(w[16]), w[24], _s1(w[29]))
    for i in range(32, upto):
        w[i] = _add(w[i - 16], _s0(w[i - 15]), w[i - 7], _s1(w[i - 2]))
    return w


def _chunk3_rounds(w, upto: int):
    st = tuple(_IV)
    for i in range(min(8, upto)):
        st = _round(st, _K[i], w[i])
    for i in range(8, min(16, upto)):
        st = _round_kw(st, _KW3[i - 8])
    for i in range(16, upto):
        st = _round(st, _K[i], w[i])
    return st


def sweep_h7_hoisted(pre, nonces):
    """Digest word h[7] of sha256d(header) for each nonce, from a hoisted
    template; the PoW limb is bswap32(h7). Rounds 61..63 never run and
    rounds 57..60 run only their e-chain: h7 = IV7 + a57 + t1_60."""
    d8 = _chunk2_digest_hoisted(pre, nonces)
    w = _chunk3_words(d8, 61)
    a57, b57, c57, d57, e, f, g, h = _chunk3_rounds(w, 57)
    for r, dprev in zip((57, 58, 59), (d57, c57, b57)):
        t1 = _add(h, _S1(e), _ch(e, f, g), _K[r], w[r])
        e, f, g, h = _add(dprev, t1), e, f, g
    t1_60 = _add(h, _S1(e), _ch(e, f, g), _K[60], w[60])
    return _add(_IV[7], a57, t1_60)


def sweep_digest_hoisted(pre, nonces):
    """The full 8-word sha256d digest state per nonce (the exact sweep's
    arithmetic)."""
    d8 = _chunk2_digest_hoisted(pre, nonces)
    st = _chunk3_rounds(_chunk3_words(d8, 64), 64)
    return [_add(v, s) for v, s in zip(_IV, st)]


def sweep_h7(midstate8, tail3, nonces):
    """Digest word h[7] of sha256d(header) for each nonce in ``nonces`` —
    the reference's unhoisted entry: the template hoisted from the
    midstate and tail words (``hoist_template``), then the per-nonce
    remainder. nonces: an int64 tensor; h7 values shaped like it."""
    return sweep_h7_hoisted(hoist_template(midstate8, tail3), nonces)


def sweep_plain(tmpl: torch.Tensor, start: int, n_tiles: int, tile: int,
                hit_fn) -> torch.Tensor:
    """The sequential tile loop on tmpl's device: sweep offsets
    [0, n_tiles * tile) from ``start`` (nonces wrap mod 2^32) in order,
    whole tiles at a time, and stop after the first tile with a hit.
    ``hit_fn(pre, nonces)`` gives the per-nonce hit mask. Returns the
    (3,) int64 tensor (found, nonce, tiles_done); nonce is 0 when not
    found."""
    pre = unpack_template(tmpl)
    dev = tmpl.device
    total = n_tiles * tile
    step = tile * max(1, PLAIN_STEP[dev.type] // tile)
    off = 0
    while off < total:
        n = min(step, total - off)
        offs = torch.arange(off, off + n, dtype=torch.int64, device=dev)
        ok = hit_fn(pre, (offs + start) & M32)
        hits = torch.nonzero(ok)
        if hits.numel():
            first = off + int(hits[0, 0])
            return torch.tensor([1, (start + first) & M32, first // tile + 1],
                                dtype=torch.int64, device=dev)
        off += n
    return torch.tensor([0, 0, n_tiles], dtype=torch.int64, device=dev)


def sweep_h7_plain(tmpl, t7: int, start: int, n_tiles: int, tile: int):
    """The plain version of the h7 entries (``sweep_fast``,
    ops/pallas_sweep.pallas_sweep): candidates are bswap32(h7) <= t7."""
    return sweep_plain(tmpl, start, n_tiles, tile,
                       lambda pre, n: bswap32(sweep_h7_hoisted(pre, n)) <= t7)


# ---- the kernel entries -----------------------------------------------------

_VP, _U32, _U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
ENTRY_ARGS = {
    # (tmpl, t7, start, n_tiles, tile, out, stream)
    "sweep_h7": [_VP, _U32, _U32, _U64, _U64, _VP, _VP],
    # (tmpl, target limbs, start, n_tiles, tile, out, stream)
    "sweep_exact": [_VP, _VP, _U32, _U64, _U64, _VP, _VP],
}
# nonces a launch may cover (the grid's block count stays far below 2^31)
MAX_LAUNCH_NONCES = 1 << 40


def check_args(tmpl: torch.Tensor, start: int, live_tiles: int,
               tile: int, **u32s) -> None:
    """Validate a sweep entry's inputs (the kernel reads them unchecked):
    the template, u32 scalars, and a launch of live_tiles * tile nonces."""
    if (tmpl.dtype != torch.int32 or tuple(tmpl.shape) != (TEMPLATE_WORDS,)
            or not tmpl.is_contiguous()):
        raise ValueError(f"template must be a contiguous ({TEMPLATE_WORDS},) "
                         f"int32 tensor, got {tmpl.dtype} {tuple(tmpl.shape)}")
    for name, v in dict(start=start, **u32s).items():
        if not 0 <= v <= M32:
            raise ValueError(f"{name}={v} is not a u32")
    if tile < 1 or live_tiles < 0 or live_tiles * tile > MAX_LAUNCH_NONCES:
        raise ValueError(f"bad sweep shape: {live_tiles} tiles of {tile}")


def launch(name: str, dev: torch.device, *args,
           count_as: str | None = None) -> torch.Tensor:
    """Launch the sweep entry ``name`` on the current stream of ``dev`` and
    count it in LAUNCHES under ``count_as`` (default ``name``). The output
    is a (4,) int64 buffer: word 0 the first hit's offset from the start
    (the kernel's atomicMin; the C entry sets it to all ones before the
    launch), words 1..3 (found, nonce, tiles_done), written by the entry's
    one-thread finalize kernel. Returns the (3,) view of words 1..3."""
    fn = cuda_build.entry(name, ENTRY_ARGS[name])
    out = torch.empty(4, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check_launch(name, fn(*args, out.data_ptr(), stream))
    LAUNCHES[count_as or name] += 1
    return out[1:]


def sweep_fast(tmpl: torch.Tensor, t7: int, start: int, n_tiles: int,
               tile: int) -> torch.Tensor:
    """Candidate sweep of [start, start + n_tiles*tile) (nonces wrap mod
    2^32): the first nonce whose hash's top LE limb bswap32(h7) is <= t7.
    K10's contract (the reference's sweep_fast_jit): returns the (3,)
    int64 tensor (found, nonce, tiles_done) on tmpl's device, tiles_done
    as the sequential tile loop counts it. Candidates need the host's
    exact check (``sweep_header_fast``)."""
    check_args(tmpl, start, n_tiles, tile, t7=t7)
    dev = tmpl.device
    if dev.type == "cpu":
        return sweep_h7_plain(tmpl, t7, start, n_tiles, tile)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no sweep kernel for device {dev}")
    return launch("sweep_h7", dev, tmpl.data_ptr(), t7, start, n_tiles, tile)


DEFAULT_TILE = 1 << 20


def sweep_header_fast(header80: bytes, target: int, start_nonce: int = 0,
                      max_nonces: int = 1 << 32, tile: int = DEFAULT_TILE):
    """Host API: find a nonce with sha256d(header) <= target, or None.

    Same contract as ops.miner.sweep_header (first hit in nonce order
    wins, returns (nonce_or_None, hashes_attempted)) on the h7 kernel:
    candidates are exact-verified on the host and the sweep resumes past
    false positives, so the result is bit-identical to the exact path. The
    search stops at the 2^32 nonce-space boundary."""
    dev = require_device("the h7 sweep")
    tmpl = header_template(header80, dev)
    t7 = int(target_to_limbs_np(target)[7])

    hashes = 0
    nonce = start_nonce & M32
    remaining = min(max_nonces, (1 << 32) - nonce)
    while remaining > 0:
        space = (1 << 32) - nonce  # tiles left before the 2^32 boundary
        n_tiles = min((remaining + tile - 1) // tile,
                      (space + tile - 1) // tile)
        found, cand, tiles = sweep_fast(tmpl, t7, nonce, n_tiles,
                                        tile).tolist()
        done = min(tiles * tile, space)
        hashes += done
        if not found:
            return None, hashes
        hdr = header80[:76] + cand.to_bytes(4, "little")
        if int.from_bytes(sha256d(hdr), "little") <= target:
            return cand, hashes
        # false positive (limb7 tie): resume just past it. The tiles the
        # device already swept before the candidate stay counted; the
        # candidate's own tile is partially re-swept.
        consumed = (cand - nonce) & M32
        remaining -= consumed + 1
        nonce = (cand + 1) & M32
        remaining = min(remaining, (1 << 32) - nonce)
    return None, hashes
