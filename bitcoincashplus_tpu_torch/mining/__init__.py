"""Mining: block template assembly + PoW search orchestration.

Reference: src/miner.cpp (BlockAssembler::CreateNewBlock :~130,
addPackageTxs :~300, IncrementExtraNonce :~440) and the generateBlocks RPC
loop (src/rpc/mining.cpp:~120) whose scalar nonce search is replaced by the
TPU sweep (ops/miner, parallel/nonce_shard).
"""

from .assembler import BlockAssembler, BlockTemplate, increment_extranonce
from .generate import generate_blocks

__all__ = [
    "BlockAssembler",
    "BlockTemplate",
    "increment_extranonce",
    "generate_blocks",
]
