"""Multi-device PoW nonce-space sharding (P2 in SURVEY.md §3.2).

Port of the reference's parallel/nonce_shard.py. There a ``shard_map``
over the ('chip',) mesh ran the single-chip tile loop on each chip's
contiguous stripe and reduced the (found, nonce) pairs over ICI. Here
each shard of the layout (parallel/mesh.py) is one launch of the exact
sweep kernel, K12's ``sweep_exact`` (csrc/sha256d_sweep.cu, through
ops/miner.sweep: the tile loop of the reference's ``_sweep_tile``, first
hit in nonce order, ``tiles_done`` as the loop counts it), on the
stripe ``start + c * n_tiles * tile`` (mod 2^32, the reference's uint32
arithmetic); the host folds the shards' (found, nonce, tiles) triples as
the reference's collectives did: the smallest found nonce (pmin), whether
any shard found one (pmax: a lone hit at 0xFFFFFFFF must survive), the
total tiles (psum) and the per-shard tiles vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.hashes import header_midstate
from ..ops.miner import DEFAULT_TILE, sweep
from ..ops.sha256 import bytes_to_words_np, target_to_limbs_np
from ..ops.sha256_sweep import M32, template_tensor, u32_tensor
from .mesh import layout, local_devices, run_shards


def _shard_sweep(dev, midstate, tail, target_limbs, stripe: int,
                 n_tiles: int, tile: int) -> torch.Tensor:
    """One shard: the exact sweep of [stripe, stripe + n_tiles * tile) on
    ``dev``; the (3,) int64 (found, nonce, tiles_done)."""
    return sweep(template_tensor(midstate, tail, dev),
                 u32_tensor(target_limbs, dev), stripe, n_tiles, tile)


def _sharded_sweep(midstate, tail, target_limbs, start_nonce, n_tiles,
                   tile: int, devices: list):
    """Sweep every shard's stripe, one launch a shard, and fold the
    results: (any_found, best nonce, total tiles, per-shard tiles)."""
    n_tiles = int(n_tiles)
    shards = [(midstate, tail, target_limbs,
               (int(start_nonce) + c * n_tiles * tile) & M32, n_tiles, tile)
              for c in range(len(devices))]
    outs = [o.tolist() for o in run_shards(devices, _shard_sweep, shards)]
    # smallest found nonce; shards without a hit contribute the maximum,
    # and any_found recovers a lone hit at 0xFFFFFFFF
    best = min(nonce if found else M32 for found, nonce, _ in outs)
    any_found = any(found for found, _, _ in outs)
    per_chip = np.array([tiles for _, _, tiles in outs], dtype=np.uint32)
    return any_found, best, int(per_chip.sum(dtype=np.uint64)), per_chip


def sweep_header_sharded(header80: bytes, target: int, start_nonce: int = 0,
                         max_nonces: int = 1 << 32,
                         tile: int = DEFAULT_TILE,
                         n_chips: int | None = None,
                         return_per_chip: bool = False,
                         devices=None):
    """Host API: multi-device PoW search. Returns (nonce or None,
    total_hashes) — or (nonce, total_hashes, per_chip_tiles) with
    return_per_chip.

    Same signature contract as ops.miner.sweep_header so callers
    (mining/generate.mine_block's `sweep` hook) can inject either.
    max_nonces is the TOTAL budget across shards; shard c owns the
    contiguous stripe [start + c*span, start + (c+1)*span) with span =
    max_nonces / n_chips. ``devices`` is the layout (default
    ``chip_mesh(n_chips)``)."""
    assert len(header80) == 80
    if n_chips is None:
        n_chips = len(local_devices()) if devices is None else len(devices)
    devices = layout(n_chips, devices)
    midstate = np.array(header_midstate(header80), dtype=np.uint32)
    tail = bytes_to_words_np(np.frombuffer(header80[64:76], dtype=np.uint8))
    tgt = target_to_limbs_np(target)
    n_tiles = max(1, max_nonces // n_chips // tile)
    found, nonce, tiles, per_chip = _sharded_sweep(
        midstate, tail, tgt, np.uint32(start_nonce), np.uint32(n_tiles),
        tile=tile, devices=devices,
    )
    hashes = int(tiles) * tile
    result = int(nonce) if bool(found) else None
    if return_per_chip:
        return result, hashes, [int(v) for v in np.asarray(per_chip)]
    return result, hashes
