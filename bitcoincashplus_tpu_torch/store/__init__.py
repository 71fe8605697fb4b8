"""Persistence layer (host copies of the reference's store/ modules:
blockstore, kvstore, chainstatedb, muhash, certificate, and the node's
sharded coins store and snapshots)."""

from .blockstore import BlockStore, MemoryBlockStore
from .kvstore import KVStore
from .chainstatedb import CoinsDB, BlockIndexDB

__all__ = ["BlockStore", "MemoryBlockStore", "KVStore", "CoinsDB",
           "BlockIndexDB"]
