"""Persistence layer (host copy of the reference's store/ modules the
block-validation slice needs: blockstore, kvstore, chainstatedb, muhash).
The sharded coins store and snapshots are later slices."""

from .blockstore import BlockStore, MemoryBlockStore
from .kvstore import KVStore
from .chainstatedb import CoinsDB, BlockIndexDB

__all__ = ["BlockStore", "MemoryBlockStore", "KVStore", "CoinsDB",
           "BlockIndexDB"]
