"""generatetoaddress / generateBlocks — the mining driver.

Reference: src/rpc/mining.cpp:~120 (generateBlocks): per block, assemble a
template, bump extranonce, then a scalar nonce `while` loop around
CheckProofOfWork. Here the inner loop is the TPU sweep (single-chip
ops/miner.sweep_header, or the multi-chip shard when a mesh is available),
and the mined block feeds back through ProcessNewBlock exactly like the
reference accepting its own block.
"""

from __future__ import annotations

from typing import Optional

from ..consensus.block import CBlock
from ..ops.dispatch import supervised_sweep
from ..ops.miner import DEFAULT_TILE
from ..validation.chainstate import ChainstateManager
from .assembler import BlockAssembler, increment_extranonce

# generateBlocks' nInnerLoopCount is 0x10000 (one extranonce bump per 64Ki
# nonces) in the reference — far too small a stride for a vectorized sweep.
# We sweep the whole 32-bit space per extranonce before bumping.
MAX_TRIES_DEFAULT = 1_000_000  # reference default nMaxTries


def mine_block(assembler: BlockAssembler, script_pubkey: bytes,
               max_tries: int = MAX_TRIES_DEFAULT,
               tile: int = DEFAULT_TILE,
               sweep=None,
               time_override: Optional[int] = None,
               extranonce_start: int = 0) -> Optional[CBlock]:
    """Assemble + PoW-search one block. Returns the mined block or None if
    max_tries hashes were exhausted. `sweep` is injectable (single-chip
    default; parallel.nonce_shard.sweep_header_sharded for a mesh;
    node._select_sweep wires mining/resident.ResidentSweep.sweep — there,
    each extranonce bump below is a device-side template BUFFER SWAP into
    the persistent resident loop, not a fresh dispatch); the
    default is the SUPERVISED single-chip sweep (ops/dispatch): a claimed
    hit is host re-verified and a dead device degrades to the scalar CPU
    loop under the miner circuit breaker.

    ``extranonce_start`` seeds the coinbase extranonce counter: two nodes
    assembling from the same parent with the same payout script and a
    MTP-pinned header time would otherwise mine byte-identical blocks
    (sub-second regtest mining made that collision real — the node layer
    passes per-block entropy; the default 0 keeps unit-test chains
    deterministic)."""
    if sweep is None:
        sweep = supervised_sweep()
    tmpl = assembler.create_new_block(script_pubkey, time_override)
    height, target = tmpl.height, tmpl.target
    block = tmpl.block
    tries_left = max_tries
    extranonce = extranonce_start
    while tries_left > 0:
        extranonce += 1
        block = increment_extranonce(block, height, extranonce)
        nonce, hashes = sweep(
            block.header.serialize(), target,
            max_nonces=min(tries_left, 1 << 32), tile=tile,
        )
        tries_left -= max(hashes, 1)
        if nonce is not None:
            mined = CBlock(block.header.with_nonce(nonce), block.vtx)
            return mined
    return None


def generate_blocks(chainstate: ChainstateManager, script_pubkey: bytes,
                    n_blocks: int, max_tries: int = MAX_TRIES_DEFAULT,
                    mempool=None, tile: int = DEFAULT_TILE,
                    sweep=None) -> list[bytes]:
    """generatetoaddress backend: mine and connect n_blocks, returning their
    hashes (wire order), like the RPC's JSON array of hex hashes."""
    if sweep is None:
        sweep = supervised_sweep()
    assembler = BlockAssembler(chainstate, mempool)
    hashes: list[bytes] = []
    for _ in range(n_blocks):
        block = mine_block(assembler, script_pubkey, max_tries, tile, sweep)
        if block is None:
            break
        chainstate.process_new_block(block)
        hashes.append(block.get_hash())
    return hashes
