"""The h7 nonce sweep at the Pallas kernel's contract.

Port of the reference's ops/pallas_sweep.py, whose ``_sweep_kernel``
(K11, ``pallas_call`` behind ``pallas_sweep_jit``) swept a (sublanes, 128)
lattice of nonces a grid step over a static grid of ``max_tiles`` steps,
with a dynamic ``n_tiles`` gating the live ones and an SMEM found flag
skipping the steps after the first hit. Here the same search runs on the
h7 kernel of ``csrc/sha256d_sweep.cu`` through its entry ``sweep_h7``
(the arithmetic and its plain version are in ops/sha256_sweep.py),
counted in LAUNCHES as ``sweep_h7_pallas``: a tile is ``sublanes * 128``
nonces, the launch covers min(n_tiles, max_tiles) tiles, and (found,
nonce, tiles_done) are those of the sequential grid. The reference's
``interpret`` switch (the Pallas interpreter) has no counterpart: a CPU
template tensor takes the plain version.

The host loop ``sweep_header_pallas`` keeps the reference's semantics,
which differ from ``sweep_header_fast`` and ``miner.sweep_header``: it
WRAPS past 2^32 (at most one full pass) instead of stopping at the
boundary, and counts every swept tile in its hashes.
"""

from __future__ import annotations

import torch

from ..crypto.hashes import sha256d
from .cuda_build import KernelUnavailable, require_device
from .sha256 import target_to_limbs_np
from .sha256_sweep import (M32, check_args, header_template, launch,
                           sweep_h7_plain)

DEFAULT_SUBLANES = 64
LANES = 128


def pallas_sweep(tmpl: torch.Tensor, t7: int, start: int, n_tiles: int,
                 sublanes: int = DEFAULT_SUBLANES,
                 max_tiles: int = 4096) -> torch.Tensor:
    """Candidate sweep of [start, start + n*tile), tile = sublanes * 128,
    n = min(n_tiles, max_tiles): the reference pallas_sweep_jit's contract.
    Returns the (3,) int64 tensor (found, nonce, tiles_done) on tmpl's
    device; nonce is 0 when not found. Candidates need the host's exact
    check."""
    tile = sublanes * LANES
    live = min(n_tiles, max_tiles)
    check_args(tmpl, start, live, tile, t7=t7, n_tiles=n_tiles,
               sublanes=sublanes, max_tiles=max_tiles)
    dev = tmpl.device
    if dev.type == "cpu":
        return sweep_h7_plain(tmpl, t7, start, live, tile)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no sweep kernel for device {dev}")
    return launch("sweep_h7", dev, tmpl.data_ptr(), t7, start, live, tile,
                  count_as="sweep_h7_pallas")


def sweep_header_pallas(header80: bytes, target: int, start_nonce: int = 0,
                        max_nonces: int = 1 << 32,
                        sublanes: int = DEFAULT_SUBLANES,
                        max_tiles: int = 4096):
    """Host API mirroring ops.sha256_sweep.sweep_header_fast on the Pallas
    contract: exact (first-hit, bit-identical) results via host
    verification of device candidates; wraps past 2^32 (module doc)."""
    dev = require_device("the pallas-h7 sweep")
    tmpl = header_template(header80, dev)
    t7 = int(target_to_limbs_np(target)[7])
    tile = sublanes * LANES

    hashes = 0
    nonce = start_nonce & M32
    remaining = max_nonces
    while remaining > 0:
        want = min((remaining + tile - 1) // tile, (1 << 32) // tile)
        n_tiles = min(want, max_tiles)
        found, cand, tiles = pallas_sweep(tmpl, t7, nonce, n_tiles,
                                          sublanes, max_tiles).tolist()
        hashes += tiles * tile
        if found:
            hdr = header80[:76] + cand.to_bytes(4, "little")
            if int.from_bytes(sha256d(hdr), "little") <= target:
                return cand, hashes
            consumed = (cand - nonce) & M32
            remaining -= consumed + 1
            nonce = (cand + 1) & M32
        else:
            remaining -= tiles * tile
            nonce = (nonce + tiles * tile) & M32
            if tiles == 0:
                break
    return None, hashes
