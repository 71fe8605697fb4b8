"""Signature cache.

Reference: src/script/sigcache.cpp:~70 (CSignatureCache) — memoizes
(sighash, pubkey, signature) triples so signatures verified at mempool
acceptance skip re-verification in ConnectBlock. Keyed identically;
consulted BEFORE building the TPU batch (SURVEY.md §3.1 sigcache row),
so steady-state block connects dispatch only never-seen signatures.

Bounded LRU-ish eviction via an ordered dict: a probe hit refreshes the
entry (move-to-end), eviction pops the stalest. The reference uses
randomized eviction / a cuckoo table; the LRU discipline preserves the
same contract — presence implies validity — while keeping the hot
mempool->block working set resident under IBD churn. Capped both in
entries and in estimated bytes (-maxsigcachesize), whichever binds
first; hit/miss/insert/eviction counters feed gettpuinfo.sigcache.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..util import lockwatch

# Estimated resident cost per entry: the 130-byte key's bytes object
# (~163 B via sys.getsizeof) plus the OrderedDict slot/link overhead.
ENTRY_COST_BYTES = 280

# Scheme tag byte appended to every entry key. Schnorr and ECDSA share
# the (sighash, r, s, pubkey) byte layout — a 64-byte Schnorr body is
# indistinguishable from a decoded DER (r, s) pair once parsed to ints —
# so without the tag a cached ECDSA TRUE would satisfy a Schnorr probe
# for the same byte material (and vice versa): presence-implies-validity
# would cross schemes. The tag makes the keyspace disjoint per algorithm.
_ALGO_TAGS = {"ecdsa": b"\x00", "schnorr": b"\x01"}


class SignatureCache:
    def __init__(self, max_entries: int = 1 << 16,
                 max_bytes: Optional[int] = None):
        self.max_entries = max_entries
        self.max_bytes = max_bytes  # None = entry cap only
        self._set: OrderedDict[bytes, None] = OrderedDict()
        # the SigService settle thread inserts verdicts concurrently with
        # accept/connect threads probing under cs_main: the compound
        # probe (membership + move_to_end) and insert (set + evict) are
        # NOT GIL-atomic — an unguarded probe could move_to_end a key the
        # settle thread's eviction just popped (KeyError out of a valid
        # block's validation). Plain Lock normally; the BCP_LOCKWATCH
        # sentinel wraps it into the lock-order graph (util/lockwatch).
        self._lock = lockwatch.watched_lock("sigcache")
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        # serving-path in-flight dedup (serving/sigservice): records that
        # missed the cache but joined an already-in-flight lane for the
        # same (sighash, r, s, pubkey) key — verified once, served twice
        self.service_dedup_hits = 0

    @staticmethod
    def entry_key(msg_hash: int, r: int, s: int, pubkey: tuple,
                  algo: str = "ecdsa") -> bytes:
        return (
            msg_hash.to_bytes(32, "big")
            + r.to_bytes(32, "big")
            + s.to_bytes(32, "big")
            + pubkey[0].to_bytes(32, "big")
            + (pubkey[1] & 1).to_bytes(1, "big")
            + _ALGO_TAGS[algo]
        )

    def note_dedup(self) -> None:
        """A SigService in-flight dedup hit (the cache itself missed, but
        the verdict was already being computed)."""
        self.service_dedup_hits += 1

    def contains(self, key: bytes) -> bool:
        with self._lock:
            if key in self._set:
                self.hits += 1
                self._set.move_to_end(key)  # LRU refresh
                return True
            self.misses += 1
            return False

    def _over_budget(self) -> bool:
        if len(self._set) > self.max_entries:
            return True
        return (self.max_bytes is not None
                and len(self._set) * ENTRY_COST_BYTES > self.max_bytes)

    def add(self, key: bytes) -> None:
        with self._lock:
            if key not in self._set:
                self.inserts += 1
            self._set[key] = None
            self._set.move_to_end(key)
            while self._set and self._over_budget():
                self._set.popitem(last=False)  # stalest first
                self.evictions += 1

    def estimated_bytes(self) -> int:
        return len(self._set) * ENTRY_COST_BYTES

    def snapshot(self) -> dict:
        """gettpuinfo.sigcache section."""
        probes = self.hits + self.misses
        return {
            "entries": len(self._set),
            "bytes": self.estimated_bytes(),
            "max_entries": self.max_entries,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "service_dedup_hits": self.service_dedup_hits,
            "hit_rate": round(self.hits / probes, 4) if probes else 0.0,
        }

    def __len__(self) -> int:
        return len(self._set)
