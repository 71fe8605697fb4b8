"""Proof-of-work nonce sweep with the exact 256-bit compare.

Port of the reference's ops/miner.py. It replaces the scalar CPU mining
loop in src/rpc/mining.cpp:~120 (generateBlocks):

    while (nMaxTries > 0 && nNonce < nInnerLoopCount &&
           !CheckProofOfWork(pblock->GetHash(), nBits, params)) ++nNonce;

with a data-parallel sweep: every nonce of [start, start + n_tiles*tile)
is hashed from the header's hoisted template (2 compressions a nonce),
compared against the target as 8 LE limbs (``le256``), and the first hit
in nonce order wins. The kernel is the exact sweep of
``csrc/sha256d_sweep.cu`` (entry ``sweep_exact``), replacing the
reference's XLA program ``sweep_jit`` (K12); ``sweep_exact_plain`` is its
plain PyTorch version. No false positives: a hit needs only the host
re-check that supervised dispatch makes of every claimed nonce.
"""

from __future__ import annotations

import time

import torch

from ..crypto.hashes import sha256d
from ..util import devicewatch as dw
from .cuda_build import KernelUnavailable, require_device
from .sha256 import digest_to_limbs, le256, target_to_limbs_np
from .sha256_sweep import (M32, check_args, header_template, launch,
                           sweep_digest_hoisted, sweep_plain, u32_tensor)

# Default tile: 64Ki nonces. A tile is the unit of the hashes count
# (tiles_done * tile); the kernel's blocks do not follow it.
DEFAULT_TILE = 1 << 16


def _boundary_tiles(start_nonce: int, max_nonces: int, tile: int) -> int:
    """Tile count for a sweep from ``start_nonce``, clamped against the
    2^32 nonce-space boundary: a sweep starting near the top must not
    wrap into (and re-hash / over-count) nonces below the start — the
    resident loop's rollover owns wrap policy, one full pass at a time."""
    space = (1 << 32) - (start_nonce & M32)
    return min((max_nonces + tile - 1) // tile, (space + tile - 1) // tile)


def target_tensor(target: int, device) -> torch.Tensor:
    """The 8 LE target limbs as an int32 bit-pattern tensor on device."""
    return u32_tensor(target_to_limbs_np(target), device)


def sweep_exact_plain(tmpl, tgt, start: int, n_tiles: int, tile: int):
    """The plain version of ``sweep``, on tmpl's device."""
    limbs = list((tgt.to(torch.int64) & M32).unbind())
    return sweep_plain(
        tmpl, start, n_tiles, tile,
        lambda pre, n: le256(digest_to_limbs(sweep_digest_hoisted(pre, n)),
                             limbs))


def sweep(tmpl: torch.Tensor, tgt: torch.Tensor, start: int, n_tiles: int,
          tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Sweep [start, start + n_tiles*tile) for a PoW hit (nonces wrap mod
    2^32 like the reference's uint32 nNonce). tmpl: the (64,) template
    (ops/sha256_sweep.template_tensor); tgt: (8,) int32 LE target limbs on
    the same device. Returns the (3,) int64 tensor (found, nonce,
    tiles_done) — the reference sweep_jit's contract; nonce is 0 when not
    found."""
    check_args(tmpl, start, n_tiles, tile)
    if (tgt.dtype != torch.int32 or tuple(tgt.shape) != (8,)
            or not tgt.is_contiguous() or tgt.device != tmpl.device):
        raise ValueError("target limbs must be a contiguous (8,) int32 "
                         "tensor on the template's device")
    dev = tmpl.device
    if dev.type == "cpu":
        return sweep_exact_plain(tmpl, tgt, start, n_tiles, tile)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no sweep kernel for device {dev}")
    return launch("sweep_exact", dev, tmpl.data_ptr(), tgt.data_ptr(),
                  start, n_tiles, tile)


def sweep_header_cpu(header80: bytes, target: int, start_nonce: int = 0,
                     max_nonces: int = 1 << 32):
    """Scalar host sweep — the reference generateBlocks inner loop
    (src/rpc/mining.cpp:~120) verbatim. This is the degraded-mode engine
    the miner circuit breaker falls back to on an injected device fault
    (ops/dispatch.supervised_sweep); same contract as
    sweep_header: first hit in nonce order wins, (nonce | None,
    hashes_attempted)."""
    if len(header80) != 80:
        raise ValueError(f"header is {len(header80)} bytes, not 80")
    base = header80[:76]
    for i in range(max_nonces):
        nonce = (start_nonce + i) & M32
        h = sha256d(base + nonce.to_bytes(4, "little"))
        if int.from_bytes(h, "little") <= target:
            return nonce, i + 1
    return None, max_nonces


def sweep_header(header80: bytes, target: int, start_nonce: int = 0,
                 max_nonces: int = 1 << 32, tile: int = DEFAULT_TILE):
    """Host API: search for a nonce making sha256d(header) <= target.

    Returns (nonce or None, hashes_attempted). The header's own nonce field
    is ignored; bytes 0..75 define the search. One launch covers the whole
    search, clamped at the 2^32 nonce-space boundary (``_boundary_tiles``);
    rollover across the boundary is the resident loop's job
    (mining/resident.py)."""
    dev = require_device("the exact sweep")
    tmpl = header_template(header80, dev)
    tgt = target_tensor(target, dev)
    n_tiles = _boundary_tiles(start_nonce, max_nonces, tile)
    # watched dispatch: the launch shape is the tile — a node uses at most
    # a couple (DEFAULT_TILE + the regtest/CPU tile)
    dw.note_transfer("miner", "h2d", 4 * (tmpl.numel() + tgt.numel()))
    t0 = time.perf_counter()
    with dw.program("miner_sweep", shape_budget=4).dispatch(tile):
        found, nonce, tiles = sweep(tmpl, tgt, start_nonce & M32, n_tiles,
                                    tile).tolist()
    dw.note_phase("miner", "execute", time.perf_counter() - t0)
    # attempted-hash accounting is also boundary-clamped: the final tile
    # may straddle 2^32, but nonces past the boundary were never part of
    # this sweep's contract
    hashes = min(tiles * tile, (1 << 32) - (start_nonce & M32))
    if found:
        return nonce, hashes
    return None, hashes
