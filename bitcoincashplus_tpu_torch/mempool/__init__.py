"""Mempool (L4) — fee-ordered transaction pool + acceptance policy.

Reference: src/txmempool.{h,cpp} (CTxMemPool, ancestor/descendant
indexing, eviction, expiry), src/validation.cpp:~400 (AcceptToMemoryPool),
src/policy/policy.cpp (IsStandardTx, AreInputsStandard).

The reference's boost::multi_index is replaced by explicit dicts + sorted
views computed on demand: the pool mutates rarely relative to template
assembly, and ancestor aggregates are maintained incrementally exactly as
the reference's CTxMemPoolEntry cached values are.
"""

from .mempool import CTxMemPool, MempoolEntry, MempoolError  # noqa: F401
from .accept import accept_to_memory_pool  # noqa: F401
from .policy import (  # noqa: F401
    DEFAULT_MIN_RELAY_FEE_RATE,
    is_standard_tx,
    are_inputs_standard,
)
