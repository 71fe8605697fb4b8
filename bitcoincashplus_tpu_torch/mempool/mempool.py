"""CTxMemPool — the fee-ordered pool with ancestor/descendant tracking.

Reference: src/txmempool.{h,cpp}. The multi_index container becomes plain
dicts; the consensus-relevant invariants are preserved exactly:

* mapNextTx: every in-pool outpoint spend is unique (no conflicts enter).
* CTxMemPoolEntry caches {count, size, fees} aggregates over BOTH the
  ancestor and descendant sets, updated incrementally on add/remove —
  these drive ancestor-feerate mining scores and descendant-score
  eviction, the same quantities addPackageTxs / TrimToSize use.
* remove_for_block prunes confirmed txs and (recursively) conflicts.

Flood-scale shape (ISSUE 20): at exchange-scale tx floods the per-query
walks around those aggregates were the wall — ``trim_to_size`` re-scanned
every entry per eviction round, ``select_for_block`` recomputed greedy
package selection from scratch per template, and every removal re-walked
the graph per tx. Admission and assembly are now batch-shaped:

* **Columns** — entry aggregates mirrored into parallel numpy arrays
  (fee/size/ancestor/descendant aggregates + entry time), kept in sync by
  the same incremental add/remove/prioritise hooks that maintain the
  per-entry caches. Limit checks and expiry scans are vectorized gathers
  instead of per-entry Python walks.
* **Frontiers** — two incrementally-maintained lazy heaps: the MINING
  frontier (max ancestor-package feerate — addPackageTxs' score) and the
  EVICTION frontier (min descendant feerate — TrimToSize's score). Every
  aggregate mutation pushes a refreshed key; stale keys are detected at
  pop (stored aggregates no longer match) and discarded. Neither is ever
  recomputed from scratch on the hot path.
* **Staged removal** — ``remove_for_block``/eviction/expiry remove whole
  sets through one ``_remove_staged`` pass that applies every surviving
  relative's aggregate fix against the PRE-removal graph (the reference's
  ``UpdateForRemoveFromMempool`` over a stage set). This also fixes a
  real leak in the old sequential path: removing a parent before its
  child (block order!) broke the child's ancestor walk, so grandparents
  kept phantom descendant aggregates forever.
* **Exact feerate order** — all score comparisons are integer
  cross-multiplications (fee_a*size_b vs fee_b*size_a) with txid
  tie-breaks, so ordering is exact and platform-stable even at fee
  magnitudes where float64 ties lie. The float ``*_fee_rate`` forms
  remain for display only. Heap keys use a 64-bit fixed-point form,
  ``(fee << 64) // size``: package sizes are bounded well below 2**32,
  so distinct rationals always map to distinct keys and the heap order
  equals the cross-multiplication order.

The per-tx reference paths survive as ``*_reference`` — they are the
fault-injection fallback (``BCP_FAULT_OPS=mempool``, fail-*) and the
differential gate's oracle (poison-output / -mempoolselfcheck): the gate
recomputes each batched verdict per-tx and any mismatch falls back to
the reference answer (counted in ``perf_snapshot``).
"""

from __future__ import annotations

import heapq
import time as _time
from typing import Iterable, Optional

import numpy as np

from ..consensus.tx import COutPoint, CTransaction
from ..consensus.tx_check import is_final_tx
from ..util.faults import INJECTOR, MEMPOOL_SITE, InjectedFault
from ..util.log import log_printf


class MempoolError(Exception):
    """Reject reason carrier (the reference's CValidationState)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}{': ' + detail if detail else ''}")


class MempoolEntry:
    """CTxMemPoolEntry (src/txmempool.h:~60)."""

    __slots__ = (
        "tx", "fee", "base_fee", "time", "entry_height", "size", "sigops",
        "spends_coinbase",
        # cached aggregates (IncludeSelf): reference's nCountWithAncestors…
        "count_with_ancestors", "size_with_ancestors", "fees_with_ancestors",
        "count_with_descendants", "size_with_descendants",
        "fees_with_descendants",
    )

    def __init__(self, tx: CTransaction, fee: int, entry_time: int,
                 entry_height: int, sigops: int = 0,
                 spends_coinbase: bool = False,
                 base_fee: Optional[int] = None):
        self.tx = tx
        # `fee` is the MODIFIED fee (base + prioritisetransaction delta) —
        # it drives every score/aggregate, like the reference's
        # nModifiedFees; `base_fee` is what the tx actually pays.
        self.base_fee = fee if base_fee is None else base_fee
        self.fee = fee
        self.time = entry_time
        self.entry_height = entry_height
        self.size = tx.size()
        self.sigops = sigops
        self.spends_coinbase = spends_coinbase
        self.count_with_ancestors = 1
        self.size_with_ancestors = self.size
        self.fees_with_ancestors = fee
        self.count_with_descendants = 1
        self.size_with_descendants = self.size
        self.fees_with_descendants = fee

    @property
    def txid(self) -> bytes:
        return self.tx.txid

    def fee_rate(self) -> float:
        """Display only — ordering uses feerate_gt/score_key (exact)."""
        return self.fee / self.size

    def ancestor_fee_rate(self) -> float:
        """The addPackageTxs mining score: package feerate (display
        only — ordering uses feerate_gt/score_key)."""
        return self.fees_with_ancestors / self.size_with_ancestors

    def descendant_fee_rate(self) -> float:
        """The TrimToSize eviction score (display only — ordering uses
        feerate_gt/score_key)."""
        return self.fees_with_descendants / self.size_with_descendants


# -- exact feerate order (ISSUE 20 satellite) --------------------------
#
# fee/size comparisons via integer cross-multiplication: exact at any
# fee magnitude (float64 ties at ~2**53) and platform-stable. Ties break
# on txid so every ordering consumer (reference scans, heaps, sorts)
# agrees byte-for-byte.

_SCORE_SHIFT = 64


def feerate_gt(fee_a: int, size_a: int, fee_b: int, size_b: int) -> bool:
    """fee_a/size_a > fee_b/size_b, exactly (sizes are positive)."""
    return fee_a * size_b > fee_b * size_a


def score_key(fee: int, size: int) -> int:
    """64-bit fixed-point feerate: (fee << 64) // size. Monotone in the
    exact rational order, and injective on DISTINCT rationals whenever
    size_a * size_b < 2**64 (package sizes are < 2**32), so comparing
    keys equals cross-multiplying — heap-friendly exactness."""
    return (fee << _SCORE_SHIFT) // size


def _pkg_better(fee_a, size_a, txid_a, fee_b, size_b, txid_b) -> bool:
    """Mining-score total order: higher package feerate wins, ties to
    the smaller txid (both paths — reference scan and frontier heap —
    use exactly this order, so templates are deterministic)."""
    if feerate_gt(fee_a, size_a, fee_b, size_b):
        return True
    if feerate_gt(fee_b, size_b, fee_a, size_a):
        return False
    return txid_a < txid_b


def _evict_worse(fee_a, size_a, txid_a, fee_b, size_b, txid_b) -> bool:
    """Eviction total order: lower descendant feerate is worse, ties to
    the smaller txid (evicted first)."""
    if feerate_gt(fee_b, size_b, fee_a, size_a):
        return True
    if feerate_gt(fee_a, size_a, fee_b, size_b):
        return False
    return txid_a < txid_b


# default policy limits (DEFAULT_ANCESTOR_LIMIT etc., src/validation.h)
DEFAULT_ANCESTOR_LIMIT = 25
DEFAULT_ANCESTOR_SIZE_LIMIT = 101_000  # bytes
DEFAULT_DESCENDANT_LIMIT = 25
DEFAULT_DESCENDANT_SIZE_LIMIT = 101_000
DEFAULT_MEMPOOL_EXPIRY = 336 * 60 * 60  # 2 weeks, seconds
DEFAULT_MAX_MEMPOOL_SIZE = 300 * 1_000_000  # -maxmempool (bytes, approx)


class MempoolColumns:
    """Parallel numpy mirror of the per-entry aggregate caches.

    One row per pool entry; rows are recycled through a free list and the
    arrays double on growth. The pool's mutation hooks mark dirty txids
    and ``sync_row`` copies the entry fields — score scans, limit checks
    and expiry cutoffs then run as vectorized gathers over live rows
    instead of per-entry Python attribute walks.
    """

    FIELDS = ("fee", "size", "fees_wa", "size_wa", "count_wa",
              "fees_wd", "size_wd", "count_wd", "time")

    __slots__ = ("cap", "txrow", "rowtx", "free", "live", "grows") + FIELDS

    def __init__(self, cap: int = 1024):
        self.cap = cap
        self.txrow: dict[bytes, int] = {}
        self.rowtx: list = [None] * cap
        self.free = list(range(cap - 1, -1, -1))
        self.live = np.zeros(cap, dtype=bool)
        self.grows = 0
        for f in self.FIELDS:
            setattr(self, f, np.zeros(cap, dtype=np.int64))

    def _grow(self) -> None:
        new_cap = self.cap * 2
        pad = self.cap
        for f in self.FIELDS:
            setattr(self, f, np.concatenate(
                [getattr(self, f), np.zeros(pad, dtype=np.int64)]))
        self.live = np.concatenate([self.live, np.zeros(pad, dtype=bool)])
        self.rowtx.extend([None] * pad)
        self.free.extend(range(new_cap - 1, self.cap - 1, -1))
        self.cap = new_cap
        self.grows += 1

    def add(self, entry: MempoolEntry) -> int:
        if not self.free:
            self._grow()
        row = self.free.pop()
        self.txrow[entry.txid] = row
        self.rowtx[row] = entry.txid
        self.live[row] = True
        self.sync_row(row, entry)
        return row

    def sync_row(self, row: int, e: MempoolEntry) -> None:
        self.fee[row] = e.fee
        self.size[row] = e.size
        self.fees_wa[row] = e.fees_with_ancestors
        self.size_wa[row] = e.size_with_ancestors
        self.count_wa[row] = e.count_with_ancestors
        self.fees_wd[row] = e.fees_with_descendants
        self.size_wd[row] = e.size_with_descendants
        self.count_wd[row] = e.count_with_descendants
        self.time[row] = e.time

    def drop(self, txid: bytes) -> None:
        row = self.txrow.pop(txid)
        self.live[row] = False
        self.rowtx[row] = None
        self.free.append(row)

    def rows_for(self, txids) -> np.ndarray:
        return np.fromiter((self.txrow[t] for t in txids),
                           dtype=np.int64, count=len(txids))

    def stale_txids(self, cutoff: int) -> list[bytes]:
        """Vectorized expiry scan: txids of live rows with time < cutoff."""
        rows = np.flatnonzero(self.live & (self.time < cutoff))
        return [self.rowtx[r] for r in rows]

    def snapshot(self) -> dict:
        return {"capacity": self.cap, "live": len(self.txrow),
                "grows": self.grows}


class CTxMemPool:
    # machine-enforced by bcplint BCP009 (the CConnman.GUARDED_BY
    # pattern): the batch-shape state — the column mirror, both frontier
    # heaps, and the perf tallies — is mutated on every pool mutation,
    # and every runtime mutation path (RPC workers, the P2P event loop,
    # the resident miner) serializes on the node's cs_main; the
    # interprocedural lockset proves it, so a future lock-free caller is
    # a lint failure, not a heisenbug.
    GUARDED_BY = {
        "columns": "cs_main",
        "_mine_heap": "cs_main",
        "_evict_heap": "cs_main",
        "perf": "cs_main",
    }

    def __init__(self, max_size_bytes: int = DEFAULT_MAX_MEMPOOL_SIZE,
                 expiry_seconds: int = DEFAULT_MEMPOOL_EXPIRY,
                 batch: bool = True, selfcheck: bool = False):
        self.entries: dict[bytes, MempoolEntry] = {}
        self.map_next_tx: dict[COutPoint, bytes] = {}  # outpoint -> spender
        # removal hook (CTxMemPool::NotifyEntryRemoved analogue): fired for
        # EVERY removal; consumers that care about the reason (the fee
        # estimator must not count block-confirmed txs as failures) handle
        # confirmed txids BEFORE remove_for_block runs
        self.on_removed = None
        self.max_size_bytes = max_size_bytes
        self.expiry_seconds = expiry_seconds
        self.total_size = 0
        self.total_fee = 0
        # bumped on every mutation; getblocktemplate longpoll + caching key
        self.sequence = 0
        # mapDeltas (PrioritiseTransaction): txid -> fee delta in satoshis.
        # Outlives pool membership — a delta set before the tx arrives is
        # applied when it enters via AcceptToMemoryPool.
        self.map_deltas: dict[bytes, int] = {}
        # -mempoolbatch: columns + frontiers on (default). Off = the
        # per-tx reference paths everywhere (the fault-fallback mode,
        # pinned by the differential suite).
        self.batch = batch
        # -mempoolselfcheck: run the differential gate on every batched
        # select/trim verdict (the poison-output drill arms it too).
        self.selfcheck = selfcheck
        self.columns = MempoolColumns() if batch else None
        # Frontier heaps (lazy deletion): entries are
        #   mining:   (-score_key(fees_wa, size_wa), txid, fees_wa, size_wa)
        #   eviction: ( score_key(fees_wd, size_wd), txid, fees_wd, size_wd)
        # a popped key is valid only if its stored aggregates still match
        # the entry's current ones; every mutation pushes a fresh key.
        self._mine_heap: list = []
        self._evict_heap: list = []
        # batch-shape observability (perf_snapshot / gettpuinfo.mempool)
        self.perf = {
            "column_syncs": 0, "rows_synced": 0,
            "frontier_pushes": 0, "frontier_stale_pops": 0,
            "frontier_rebuilds": 0,
            "bulk_evict_episodes": 0, "bulk_evicted": 0,
            "staged_removals": 0,
            "select_batched": 0, "select_fallbacks": 0,
            "trim_fallbacks": 0, "selfchecks": 0, "poisoned_verdicts": 0,
        }

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def __contains__(self, txid: bytes) -> bool:
        return txid in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, txid: bytes) -> Optional[MempoolEntry]:
        return self.entries.get(txid)

    def get_tx(self, txid: bytes) -> Optional[CTransaction]:
        e = self.entries.get(txid)
        return e.tx if e else None

    def get_spender(self, outpoint: COutPoint) -> Optional[bytes]:
        return self.map_next_tx.get(outpoint)

    def get_output(self, outpoint: COutPoint):
        """CCoinsViewMemPool leg: an in-pool tx's output, or None."""
        e = self.entries.get(outpoint.hash)
        if e is not None and outpoint.n < len(e.tx.vout):
            return e.tx.vout[outpoint.n]
        return None

    def parents_in_pool(self, tx: CTransaction) -> set[bytes]:
        return {
            txin.prevout.hash
            for txin in tx.vin
            if txin.prevout.hash in self.entries
        }

    def calculate_ancestors(self, tx: CTransaction) -> set[bytes]:
        """CalculateMemPoolAncestors: transitive in-pool ancestor txids."""
        out: set[bytes] = set()
        stack = list(self.parents_in_pool(tx))
        while stack:
            txid = stack.pop()
            if txid in out:
                continue
            out.add(txid)
            stack.extend(self.parents_in_pool(self.entries[txid].tx))
        return out

    def calculate_descendants(self, txid: bytes) -> set[bytes]:
        """CalculateDescendants: txid + everything depending on it."""
        out: set[bytes] = set()
        stack = [txid]
        while stack:
            cur = stack.pop()
            if cur in out or cur not in self.entries:
                continue
            out.add(cur)
            e = self.entries[cur]
            for i in range(len(e.tx.vout)):
                spender = self.map_next_tx.get(COutPoint(cur, i))
                if spender is not None:
                    stack.append(spender)
        return out

    def check_ancestor_limits(
        self, tx: CTransaction, fee: int,
        limit_count: int = DEFAULT_ANCESTOR_LIMIT,
        limit_size: int = DEFAULT_ANCESTOR_SIZE_LIMIT,
        limit_desc: int = DEFAULT_DESCENDANT_LIMIT,
        limit_desc_size: int = DEFAULT_DESCENDANT_SIZE_LIMIT,
    ) -> set[bytes]:
        """CalculateMemPoolAncestors' limit-enforcing form; returns the
        ancestor set or raises MempoolError (too-long-mempool-chain).
        Batch mode gathers the ancestor rows from the columns — the sums
        and the per-ancestor descendant-limit probes are one vectorized
        pass instead of a Python attribute walk per ancestor."""
        ancestors = self.calculate_ancestors(tx)
        if len(ancestors) + 1 > limit_count:
            raise MempoolError("too-long-mempool-chain", "ancestor count")
        if self.batch and ancestors:
            rows = self.columns.rows_for(ancestors)
            size = tx.size() + int(self.columns.size[rows].sum())
            if size > limit_size:
                raise MempoolError("too-long-mempool-chain", "ancestor size")
            if bool((self.columns.count_wd[rows] + 1 > limit_desc).any()):
                raise MempoolError("too-long-mempool-chain",
                                   "descendant count")
            if bool((self.columns.size_wd[rows] + tx.size()
                     > limit_desc_size).any()):
                raise MempoolError("too-long-mempool-chain",
                                   "descendant size")
            return ancestors
        size = tx.size() + sum(self.entries[a].size for a in ancestors)
        if size > limit_size:
            raise MempoolError("too-long-mempool-chain", "ancestor size")
        for a in ancestors:
            e = self.entries[a]
            if e.count_with_descendants + 1 > limit_desc:
                raise MempoolError("too-long-mempool-chain",
                                   "descendant count")
            if e.size_with_descendants + tx.size() > limit_desc_size:
                raise MempoolError("too-long-mempool-chain",
                                   "descendant size")
        return ancestors

    # ------------------------------------------------------------------
    # column / frontier maintenance
    # ------------------------------------------------------------------

    def _push_frontiers(self, e: MempoolEntry) -> None:
        heapq.heappush(self._mine_heap, (
            -score_key(e.fees_with_ancestors, e.size_with_ancestors),
            e.txid, e.fees_with_ancestors, e.size_with_ancestors))
        heapq.heappush(self._evict_heap, (
            score_key(e.fees_with_descendants, e.size_with_descendants),
            e.txid, e.fees_with_descendants, e.size_with_descendants))
        self.perf["frontier_pushes"] += 2
        # lazy-heap hygiene: dead keys accumulate per mutation; compact
        # when the heaps dwarf the pool so memory stays O(pool)
        if len(self._mine_heap) > max(256, 8 * len(self.entries)):
            self._rebuild_frontiers()

    def _rebuild_frontiers(self) -> None:
        self._mine_heap = [
            (-score_key(e.fees_with_ancestors, e.size_with_ancestors),
             t, e.fees_with_ancestors, e.size_with_ancestors)
            for t, e in self.entries.items()]
        self._evict_heap = [
            (score_key(e.fees_with_descendants, e.size_with_descendants),
             t, e.fees_with_descendants, e.size_with_descendants)
            for t, e in self.entries.items()]
        heapq.heapify(self._mine_heap)
        heapq.heapify(self._evict_heap)
        self.perf["frontier_rebuilds"] += 1

    def _sync(self, dirty: Iterable[bytes]) -> None:
        """One column write + frontier key push per dirty SURVIVING txid —
        called once at the end of every mutating operation (the batch
        analogue of the reference's per-entry cache updates)."""
        if not self.batch:
            return
        self.perf["column_syncs"] += 1
        cols = self.columns
        for txid in dirty:
            e = self.entries.get(txid)
            if e is None:
                continue
            cols.sync_row(cols.txrow[txid], e)
            self.perf["rows_synced"] += 1
            self._push_frontiers(e)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def add_unchecked(self, entry: MempoolEntry,
                      ancestors: Optional[set[bytes]] = None) -> None:
        """addUnchecked (txmempool.cpp:~350): caller has validated."""
        txid = entry.txid
        assert txid not in self.entries
        if ancestors is None:
            ancestors = self.calculate_ancestors(entry.tx)
        self.entries[txid] = entry
        for txin in entry.tx.vin:
            assert txin.prevout not in self.map_next_tx, "conflicting spend"
            self.map_next_tx[txin.prevout] = txid
        # update aggregates: self's ancestor cache, ancestors' descendant
        # caches (UpdateAncestorsOf / UpdateEntryForAncestors)
        for a in ancestors:
            ae = self.entries[a]
            ae.count_with_descendants += 1
            ae.size_with_descendants += entry.size
            ae.fees_with_descendants += entry.fee
            entry.count_with_ancestors += 1
            entry.size_with_ancestors += ae.size
            entry.fees_with_ancestors += ae.fee
        self.total_size += entry.size
        self.total_fee += entry.fee
        self.sequence += 1
        if self.batch:
            self.columns.add(entry)
            self._push_frontiers(entry)
            self._sync(ancestors)

    def _remove_staged(self, stage: set[bytes]) -> list[bytes]:
        """RemoveStaged/UpdateForRemoveFromMempool: remove a whole set in
        one pass. Every surviving relative's aggregate fix is computed
        against the PRE-removal graph while all stage entries are still
        present — parent-before-child removal order can no longer break
        an ancestor walk (the sequential ``_remove_one`` leak).
        Returns the removed txids, children-first (the old
        remove_recursive emission order)."""
        if not stage:
            return []
        dirty: set[bytes] = set()
        for txid in stage:
            e = self.entries[txid]
            for a in self.calculate_ancestors(e.tx):
                if a in stage:
                    continue
                ae = self.entries[a]
                ae.count_with_descendants -= 1
                ae.size_with_descendants -= e.size
                ae.fees_with_descendants -= e.fee
                dirty.add(a)
            for d in self.calculate_descendants_of_outputs(e.tx):
                if d in stage:
                    continue
                de = self.entries[d]
                de.count_with_ancestors -= 1
                de.size_with_ancestors -= e.size
                de.fees_with_ancestors -= e.fee
                dirty.add(d)
        out = sorted(
            stage,
            key=lambda t: (-self.entries[t].count_with_ancestors, t))
        for txid in out:
            entry = self.entries.pop(txid)
            if self.on_removed is not None:
                self.on_removed(txid)
            for txin in entry.tx.vin:
                self.map_next_tx.pop(txin.prevout, None)
            self.total_size -= entry.size
            self.total_fee -= entry.fee
            self.sequence += 1
            if self.batch:
                self.columns.drop(txid)
        self.perf["staged_removals"] += 1
        self._sync(dirty)
        return out

    def _remove_one(self, txid: bytes) -> None:
        """Remove JUST this tx (descendants re-anchor) — a 1-element
        stage."""
        self._remove_staged({txid})

    def prioritise(self, txid: bytes, fee_delta: int) -> None:
        """PrioritiseTransaction (txmempool.cpp:~800): accumulate a fee
        delta for txid and, if it is in the pool, push the delta through
        its own and its relatives' fee aggregates."""
        self.map_deltas[txid] = self.map_deltas.get(txid, 0) + fee_delta
        entry = self.entries.get(txid)
        if entry is None:
            return
        entry.fee += fee_delta
        entry.fees_with_ancestors += fee_delta
        entry.fees_with_descendants += fee_delta
        dirty = {txid}
        for a in self.calculate_ancestors(entry.tx):
            self.entries[a].fees_with_descendants += fee_delta
            dirty.add(a)
        for d in self.calculate_descendants_of_outputs(entry.tx):
            self.entries[d].fees_with_ancestors += fee_delta
            dirty.add(d)
        self.total_fee += fee_delta
        self.sequence += 1
        self._sync(dirty)

    def calculate_descendants_of_outputs(self, tx: CTransaction) -> set[bytes]:
        out: set[bytes] = set()
        for i in range(len(tx.vout)):
            spender = self.map_next_tx.get(COutPoint(tx.txid, i))
            if spender is not None:
                out |= self.calculate_descendants(spender)
        return out

    def remove_recursive(self, txid: bytes) -> list[bytes]:
        """removeRecursive: tx + all descendants. Returns removed txids."""
        return self._remove_staged(self.calculate_descendants(txid))

    def remove_for_block(self, block_txs: Iterable[CTransaction]) -> None:
        """removeForBlock: drop confirmed txs, then conflicts (anything
        spending an outpoint a block tx just spent). One staged removal
        for the whole block — the ancestor/descendant fixes amortize
        across the block's txs instead of re-walking per removal."""
        stage: set[bytes] = set()
        for tx in block_txs:
            # ClearPrioritisation: a confirmed tx's fee delta is spent
            # (coinbases included — their txids can carry stray deltas)
            self.map_deltas.pop(tx.txid, None)
            if tx.is_coinbase():
                continue
            if tx.txid in self.entries:
                # confirmed: remove JUST this tx (descendants re-anchor)
                stage.add(tx.txid)
            for txin in tx.vin:
                conflict = self.map_next_tx.get(txin.prevout)
                if (conflict is not None and conflict != tx.txid
                        and conflict not in stage):
                    stage |= self.calculate_descendants(conflict)
        self._remove_staged(stage)

    def expire(self, now: Optional[int] = None) -> int:
        """Expire (txmempool.cpp:~600): drop entries older than the expiry
        window, with their descendants. Batch mode finds the stale set
        with one vectorized cutoff scan over the time column."""
        now = now if now is not None else int(_time.time())
        cutoff = now - self.expiry_seconds
        if self.batch:
            stale = self.columns.stale_txids(cutoff)
        else:
            stale = [t for t, e in self.entries.items() if e.time < cutoff]
        stage: set[bytes] = set()
        for txid in stale:
            if txid not in stage:
                stage |= self.calculate_descendants(txid)
        return len(self._remove_staged(stage))

    # ------------------------------------------------------------------
    # eviction (TrimToSize)
    # ------------------------------------------------------------------

    def _worst_reference(self) -> bytes:
        """Per-tx oracle: the entry with the lowest descendant feerate
        (exact comparison, smaller txid on ties)."""
        worst = None
        for e in self.entries.values():
            if worst is None or _evict_worse(
                    e.fees_with_descendants, e.size_with_descendants,
                    e.txid, worst.fees_with_descendants,
                    worst.size_with_descendants, worst.txid):
                worst = e
        return worst.txid

    def _pop_worst_evict(self) -> bytes:
        """Pop the eviction frontier until a FRESH key surfaces (stored
        descendant aggregates still match the live entry)."""
        while self._evict_heap:
            _key, txid, f, s = heapq.heappop(self._evict_heap)
            e = self.entries.get(txid)
            if (e is None or e.fees_with_descendants != f
                    or e.size_with_descendants != s):
                self.perf["frontier_stale_pops"] += 1
                continue
            return txid
        # heap starved (only possible after external surgery): rebuild
        self._rebuild_frontiers()
        return self._pop_worst_evict()

    def trim_to_size(self, max_bytes: Optional[int] = None) -> list[bytes]:
        """TrimToSize: evict lowest descendant-score packages until the
        pool fits. Returns removed txids. Batched: victims come off the
        incrementally-maintained eviction frontier (amortized O(log n)
        per victim) instead of a full O(n) score scan per round; the
        surviving ancestors the staged removal dirties are re-pushed with
        fresh keys, so the next round's pop is already exact."""
        max_bytes = max_bytes if max_bytes is not None else self.max_size_bytes
        if self.total_size <= max_bytes:
            return []
        if not self.batch:
            return self._trim_reference(max_bytes)
        try:
            INJECTOR.on_call(MEMPOOL_SITE)
        except InjectedFault:
            self.perf["trim_fallbacks"] += 1
            return self._trim_reference(max_bytes)
        gate = self.selfcheck or (INJECTOR.mode == "poison-output"
                                  and INJECTOR.armed_for(MEMPOOL_SITE))
        poison = gate and INJECTOR.should_poison(MEMPOOL_SITE)
        removed: list[bytes] = []
        episode = False
        while self.total_size > max_bytes and self.entries:
            victim = self._pop_worst_evict()
            if gate:
                self.perf["selfchecks"] += 1
                checked = victim
                if poison and len(self.entries) > 1:
                    # corrupt the batched verdict: claim a different
                    # victim — the differential gate must catch it
                    checked = next(t for t in self.entries if t != victim)
                oracle = self._worst_reference()
                if checked != oracle:
                    self.perf["poisoned_verdicts"] += 1
                    log_printf(
                        "mempool: batched evict verdict poisoned/diverged "
                        "(got %s, oracle %s) — using the per-tx oracle",
                        checked.hex()[:16], oracle.hex()[:16])
                    if victim != oracle:
                        # the popped key belonged to a survivor — re-push
                        # it so the frontier stays complete
                        self._push_frontiers(self.entries[victim])
                    victim = oracle
            removed.extend(self._remove_staged(
                self.calculate_descendants(victim)))
            episode = True
        if episode:
            self.perf["bulk_evict_episodes"] += 1
            self.perf["bulk_evicted"] += len(removed)
        return removed

    def _trim_reference(self, max_bytes: int) -> list[bytes]:
        """The per-tx fallback: full worst-scan per eviction round."""
        removed: list[bytes] = []
        while self.total_size > max_bytes and self.entries:
            removed.extend(self._remove_staged(
                self.calculate_descendants(self._worst_reference())))
        return removed

    # ------------------------------------------------------------------
    # mining interface (BlockAssembler.addPackageTxs parity)
    # ------------------------------------------------------------------

    def _nonfinal_poison(self, height: int, block_time: int) -> set[bytes]:
        """IsFinalTx gate (addPackageTxs → TestBlockValidity parity): a
        non-final tx poisons its whole descendant subtree for this
        block."""
        skipped: set[bytes] = set()
        for txid, e in self.entries.items():
            if txid not in skipped and not is_final_tx(e.tx, height,
                                                       block_time):
                skipped |= self.calculate_descendants(txid)
        return skipped

    def select_for_block(self, max_size: int, height: int,
                         block_time: int) -> list[MempoolEntry]:
        """Greedy ancestor-feerate package selection — addPackageTxs
        (src/miner.cpp:~300): repeatedly take the entry with the best
        ancestor-package feerate, emit its not-yet-selected ancestors
        first (topological order), and account the whole package; skip
        packages that would overflow the block.

        Batched: candidates pop off the incrementally-maintained mining
        frontier; emitted packages re-score their remaining descendants
        through a local modified-package map (the reference's
        mapModifiedTx) with refreshed heap keys — no full rescan per
        round. Byte-identical to the per-tx reference path (the
        differential gate / -mempoolselfcheck asserts it live)."""
        if not self.batch:
            return self._select_reference(max_size, height, block_time)
        try:
            INJECTOR.on_call(MEMPOOL_SITE)
        except InjectedFault:
            self.perf["select_fallbacks"] += 1  # BCPLINT-IGNORE[BCP009]: caller holds cs_main through BlockAssembler (untyped mempool param hides the edge)
            return self._select_reference(max_size, height, block_time)
        self.perf["select_batched"] += 1
        selected = self._select_batched(max_size, height, block_time)
        gate = self.selfcheck or (INJECTOR.mode == "poison-output"
                                  and INJECTOR.armed_for(MEMPOOL_SITE))
        if gate:
            self.perf["selfchecks"] += 1
            checked = selected
            if INJECTOR.should_poison(MEMPOOL_SITE) and selected:
                checked = selected[:-1]  # corrupted batched verdict
            oracle = self._select_reference(max_size, height, block_time)
            if [e.txid for e in checked] != [e.txid for e in oracle]:
                self.perf["poisoned_verdicts"] += 1
                log_printf(
                    "mempool: batched template selection poisoned/"
                    "diverged (%d vs oracle %d txs) — using the per-tx "
                    "oracle", len(checked), len(oracle))
                return oracle
        return selected

    def _select_batched(self, max_size: int, height: int,
                        block_time: int) -> list[MempoolEntry]:
        selected: list[MempoolEntry] = []
        in_block: set[bytes] = set()
        used = 0
        skipped = self._nonfinal_poison(height, block_time)
        failed: set[bytes] = set()  # overflowed packages, final this block
        # local working copy of the global frontier (lazy keys included;
        # staleness is re-checked against mod/entry state at pop)
        heap = list(self._mine_heap)
        # mapModifiedTx: package aggregates minus what's already in the
        # block, for entries whose ancestors got emitted
        mod: dict[bytes, tuple[int, int]] = {}
        while heap:
            _key, txid, sf, ss = heapq.heappop(heap)
            e = self.entries.get(txid)
            if (e is None or txid in in_block or txid in skipped
                    or txid in failed):
                continue
            cur = mod.get(txid)
            if cur is None:
                cur = (e.fees_with_ancestors, e.size_with_ancestors)
            if (sf, ss) != cur:
                self.perf["frontier_stale_pops"] += 1  # BCPLINT-IGNORE[BCP009]: caller holds cs_main through BlockAssembler (untyped mempool param hides the edge)
                continue
            pkg_fees, pkg_size = cur
            if used + pkg_size > max_size:
                failed.add(txid)
                continue
            anc = [a for a in self.calculate_ancestors(e.tx)
                   if a not in in_block]
            # topological emit: parents before children (deterministic —
            # count ties break on txid, both paths)
            order = sorted(
                anc + [txid],
                key=lambda t: (self.entries[t].count_with_ancestors, t))
            for t in order:
                selected.append(self.entries[t])
                in_block.add(t)
            used += pkg_size
            # rescoring (mapModifiedTx): every not-in-block descendant of
            # an emitted tx loses that tx from its effective package
            for t in order:
                te = self.entries[t]
                for d in self.calculate_descendants(t):
                    if d in in_block:
                        continue
                    df, ds = mod.get(d) or (
                        self.entries[d].fees_with_ancestors,
                        self.entries[d].size_with_ancestors)
                    df -= te.fee
                    ds -= te.size
                    mod[d] = (df, ds)
                    heapq.heappush(heap, (-score_key(df, ds), d, df, ds))
        return selected

    def _select_reference(self, max_size: int, height: int,
                          block_time: int) -> list[MempoolEntry]:
        """The per-tx oracle: full package re-scan per selection round
        (the pre-batch greedy loop, now on the exact comparator)."""
        selected: list[MempoolEntry] = []
        in_block: set[bytes] = set()
        used = 0
        skipped = self._nonfinal_poison(height, block_time)
        while True:
            best: Optional[MempoolEntry] = None
            best_f = best_s = 0
            best_pkg: Optional[list[bytes]] = None
            for e in self.entries.values():
                if e.txid in in_block or e.txid in skipped:
                    continue
                anc = [
                    a for a in self.calculate_ancestors(e.tx)
                    if a not in in_block
                ]
                pkg_size = e.size + sum(self.entries[a].size for a in anc)
                pkg_fees = e.fee + sum(self.entries[a].fee for a in anc)
                if best is None or _pkg_better(pkg_fees, pkg_size, e.txid,
                                               best_f, best_s, best.txid):
                    best, best_f, best_s = e, pkg_fees, pkg_size
                    best_pkg = anc + [e.txid]
            if best is None:
                return selected
            if used + best_s > max_size:
                skipped.add(best.txid)
                continue
            # topological emit: parents before children (deterministic —
            # count ties break on txid, both paths)
            order = sorted(
                best_pkg,
                key=lambda t: (self.entries[t].count_with_ancestors, t))
            for txid in order:
                selected.append(self.entries[txid])
                in_block.add(txid)
            used += best_s

    def info(self) -> dict:
        """getmempoolinfo backend."""
        return {
            "size": len(self.entries),
            "bytes": self.total_size,
            "total_fee": self.total_fee,
            "maxmempool": self.max_size_bytes,
        }

    def perf_snapshot(self) -> dict:
        """gettpuinfo.mempool / getmempoolinfo.perf: the batch-shape
        counters — frontier depths, column-sync tallies, bulk-evict
        episodes, fallback/differential-gate verdicts."""
        out = {
            "batch": self.batch,
            "selfcheck": self.selfcheck,
            "frontier_depth": {"mining": len(self._mine_heap),
                               "evict": len(self._evict_heap)},
            "columns": (self.columns.snapshot() if self.batch
                        else {"capacity": 0, "live": 0, "grows": 0}),
        }
        out.update(self.perf)
        return out
