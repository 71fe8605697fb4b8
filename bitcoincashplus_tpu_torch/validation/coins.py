"""UTXO set model.

Reference: src/coins.{h,cpp} (Coin, CCoinsView, CCoinsViewBacked,
CCoinsViewCache), src/undo.h (CTxUndo/CBlockUndo). The layering is the same
as the reference's: persistent store <- in-memory cache <- per-operation
edits, with a batched flush. The persistent side is store/chainstate.py
(sqlite standing in for LevelDB — SURVEY.md §8.5.6 documents the deviation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from ..consensus.serialize import (
    ByteReader,
    deser_compact_size,
    deser_var_bytes,
    ser_compact_size,
    ser_var_bytes,
)
from ..consensus.tx import COutPoint, CTransaction, CTxOut


@dataclass(frozen=True)
class Coin:
    """An unspent output: CTxOut + metadata (src/coins.h:~30 (Coin)).
    height carries the creating block's height; coinbase outputs are
    spendable only after COINBASE_MATURITY confirmations."""

    out: CTxOut
    height: int
    is_coinbase: bool

    def serialize(self) -> bytes:
        code = self.height * 2 + (1 if self.is_coinbase else 0)
        return (
            ser_compact_size(code)
            + ser_compact_size(self.out.value)
            + ser_var_bytes(self.out.script_pubkey)
        )

    @classmethod
    def deserialize(cls, b: bytes) -> "Coin":
        r = ByteReader(b)
        code = deser_compact_size(r, range_check=False)
        value = deser_compact_size(r, range_check=False)
        script = deser_var_bytes(r)
        return cls(CTxOut(value, script), code // 2, bool(code & 1))


class CoinsView:
    """Abstract view of the UTXO set — CCoinsView (src/coins.h:~150)."""

    def get_coin(self, outpoint: COutPoint) -> Optional[Coin]:
        raise NotImplementedError

    def have_coin(self, outpoint: COutPoint) -> bool:
        return self.get_coin(outpoint) is not None

    def best_block(self) -> bytes:
        raise NotImplementedError

    def batch_write(self, coins: dict, best_block: bytes) -> None:
        raise NotImplementedError


class MemoryCoinsView(CoinsView):
    """Dict-backed bottom view (tests + regtest-in-memory operation)."""

    def __init__(self):
        self._coins: dict[COutPoint, Coin] = {}
        self._best = b"\x00" * 32

    def get_coin(self, outpoint):
        return self._coins.get(outpoint)

    def best_block(self) -> bytes:
        return self._best

    def batch_write(self, coins, best_block):
        for op, coin in coins.items():
            if coin is None:
                self._coins.pop(op, None)
            else:
                self._coins[op] = coin
        self._best = best_block

    def __len__(self):
        return len(self._coins)

    def all_coins(self) -> Iterator[tuple[COutPoint, Coin]]:
        return iter(self._coins.items())


class CoinsCache(CoinsView):
    """Write-back cache over a backing view — CCoinsViewCache
    (src/coins.h:~200). Entries: present Coin = live; None = spent/deleted
    (tombstone to push down on flush); absent = not yet fetched."""

    def __init__(self, base: CoinsView):
        self.base = base
        self.cache: dict[COutPoint, Optional[Coin]] = {}
        self._dirty: set[COutPoint] = set()  # CCoinsCacheEntry::DIRTY
        self._best: Optional[bytes] = None

    # -- reads --

    def get_coin(self, outpoint):
        if outpoint in self.cache:
            return self.cache[outpoint]
        coin = self.base.get_coin(outpoint)
        if coin is not None:
            self.cache[outpoint] = coin  # clean read-through entry
        return coin

    def have_coin_in_cache(self, outpoint) -> bool:
        return self.cache.get(outpoint) is not None

    def have_coin(self, outpoint) -> bool:
        """HaveCoin without materializing: a cache-resident entry (live or
        tombstone) answers immediately; otherwise the base is asked for
        EXISTENCE only — no Coin deserialization, no read-through entry
        polluting this layer (the BIP30 scan probes every output of every
        tx, and caching those misses-by-construction would bloat the
        -dbcache working set for nothing)."""
        if outpoint in self.cache:
            return self.cache[outpoint] is not None
        return self.base.have_coin(outpoint)

    def have_coin_cached(self, outpoint) -> Optional[bool]:
        """Resolve have_coin from in-memory cache layers ALONE: True/False
        when some layer holds the entry (live or tombstone), None when the
        bottom store would have to be consulted. The BIP30 fast path uses
        this to count store probes actually saved."""
        if outpoint in self.cache:
            return self.cache[outpoint] is not None
        probe = getattr(self.base, "have_coin_cached", None)
        return probe(outpoint) if probe is not None else None

    def best_block(self) -> bytes:
        if self._best is None:
            self._best = self.base.best_block()
        return self._best

    def set_best_block(self, h: bytes) -> None:
        self._best = h

    # -- writes --

    def add_coin(self, outpoint: COutPoint, coin: Coin, overwrite: bool = False):
        """AddCoin (src/coins.cpp:~50). Refuses silent overwrite of an
        unspent coin unless overwrite (the BIP30 special-case plumbing)."""
        if not overwrite and self.cache.get(outpoint) is not None:
            raise ValueError(f"coin already present: {outpoint!r}")
        self.cache[outpoint] = coin
        self._dirty.add(outpoint)

    def spend_coin(self, outpoint: COutPoint) -> Optional[Coin]:
        """SpendCoin: returns the spent coin (for undo data), tombstones it."""
        coin = self.get_coin(outpoint)
        if coin is None:
            return None
        self.cache[outpoint] = None
        self._dirty.add(outpoint)
        return coin

    def batch_write(self, coins: dict, best_block: bytes) -> None:
        """Absorb a child cache layer's (dirty) edits —
        CCoinsViewCache::BatchWrite. Tombstones stay tombstones until the
        bottom store sees them."""
        for op, coin in coins.items():
            self.cache[op] = coin
            self._dirty.add(op)
        self._best = best_block

    def flush(self) -> None:
        """Push DIRTY edits to the base in one batch — CCoinsViewCache::Flush.
        Clean read-through entries are dropped, not written (the reference's
        DIRTY-flag behavior: flush cost scales with modifications, not with
        the read set). The batch plus best-block marker is the crash-safety
        unit (SURVEY.md §6.3)."""
        self.base.batch_write(
            {op: self.cache[op] for op in self._dirty}, self.best_block()
        )
        self.cache.clear()
        self._dirty.clear()

    def cache_size(self) -> int:
        return len(self.cache)

    def estimated_bytes(self) -> int:
        """DynamicMemoryUsage analogue (coins.cpp): rough per-entry cost of
        the Python dict entry + COutPoint + Coin (~250 bytes measured with
        sys.getsizeof over the populated structures). Drives the -dbcache
        flush threshold, so it needs to be proportional, not exact."""
        return len(self.cache) * 250


def add_coins(view: CoinsCache, tx: CTransaction, height: int, overwrite: bool = False):
    """AddCoins (src/coins.cpp:~70): create outputs of tx at height."""
    cb = tx.is_coinbase()
    txid = tx.txid
    for i, out in enumerate(tx.vout):
        view.add_coin(COutPoint(txid, i), Coin(out, height, cb), overwrite or cb)


# ---- undo data (src/undo.h) ----

@dataclass
class TxUndo:
    """Spent coins of one transaction, input order — CTxUndo."""

    prevouts: list[Coin]

    def serialize(self) -> bytes:
        b = ser_compact_size(len(self.prevouts))
        for c in self.prevouts:
            s = c.serialize()
            b += ser_compact_size(len(s)) + s
        return b

    @classmethod
    def deserialize(cls, r: ByteReader) -> "TxUndo":
        n = deser_compact_size(r)
        prevouts = []
        for _ in range(n):
            ln = deser_compact_size(r)
            prevouts.append(Coin.deserialize(r.read_bytes(ln)))
        return cls(prevouts)


@dataclass
class BlockUndo:
    """Per-block undo data (rev?????.dat payload) — CBlockUndo. One TxUndo
    per non-coinbase transaction, block order."""

    vtxundo: list[TxUndo]

    def serialize(self) -> bytes:
        b = ser_compact_size(len(self.vtxundo))
        for u in self.vtxundo:
            b += u.serialize()
        return b

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlockUndo":
        r = ByteReader(data)
        n = deser_compact_size(r)
        return cls([TxUndo.deserialize(r) for _ in range(n)])
