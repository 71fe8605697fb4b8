"""Validation engine (L4) — the consensus state machine.

Mirrors the function inventory of src/validation.{h,cpp} (SURVEY.md §3.1):
ProcessNewBlock / AcceptBlock / ConnectBlock / DisconnectBlock /
ActivateBestChain / FlushStateToDisk over a layered UTXO view
(coins.py ← store/), with undo data for reorgs.

Host-side orchestration is Python (single asyncio-friendly thread; the
reference's cs_main lock has no equivalent because there is no shared-memory
threading here); the compute-bound legs — header PoW batches, Merkle roots,
signature batches — dispatch to ops/ kernels.
"""

from .chain import BlockStatus, CBlockIndex, CChain
from .coins import Coin, CoinsCache
from .chainstate import ChainstateManager

__all__ = [
    "BlockStatus",
    "CBlockIndex",
    "CChain",
    "Coin",
    "CoinsCache",
    "ChainstateManager",
]
