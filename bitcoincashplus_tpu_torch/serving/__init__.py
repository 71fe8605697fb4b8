"""Always-on signing + fleet serving.

The persistent micro-batching SigService (ISSUE 7) generalizes the
pipelined IBD engine's cross-block LanePacker into a serving front-end
for live traffic: mempool acceptance, compact-block reconstruction, and
getblocktemplate re-validation enqueue per-input script checks into
shared device lanes and await per-tx futures.

The fleet front door (ISSUE 16) scales the read path horizontally:
serving/replicas pools snapshot-bootstrapped read replicas behind
health probes, breakers and a lag gate; serving/gateway load-balances
client RPC over them with token-bucket admission, request coalescing
and storm-proof failover.
"""

from .gateway import Gateway  # noqa: F401
from .replicas import Replica, ReplicaPool  # noqa: F401
from .sigservice import (  # noqa: F401
    SigService,
    TxSigFuture,
    prewarm_block_sigs,
)
