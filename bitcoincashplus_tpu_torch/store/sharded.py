"""Sharded chainstate store: N hash-partitioned coins backends behind
one CoinsView facade.

The single-writer ``CoinsDB`` commit (store/chainstatedb.py) funnels every
settled batch into one journaled sqlite transaction — the remaining wall
for a production-sized chainstate (ROADMAP "Net effect" after PR 11).
``ShardedCoinsDB`` splits the coin keyspace across N ``KVStore`` backends
(outpoint-keyed, crc32(key) & (N-1), power-of-two N) so one settle's
batch partitions per shard and the sqlite applies + fsyncs run on a
parallel executor. ``CoinsDB`` stays the 1-shard degenerate case;
``ChainstateManager``/``CoinsCache.flush`` route through this facade
untouched above the store seam.

Crash-safety contract (the PR 1 journal, per shard, plus one cross-shard
epoch): every commit carries an epoch stamp E (monotonic, per-shard meta
row ``b"E"`` + the manifest). Step order IS the contract:

  1. per-shard journals made durable, sequentially (fsync-before-rename;
     the ``store_shard`` fault site fires at the head of each leg — a
     failing shard aborts the WHOLE commit and unlinks the journals
     already written, so no shard is ever ahead of the manifest epoch);
  2. per-shard sqlite applies + fsyncs on the executor;
  3. the manifest (``chainstate.manifest.json``) is atomically rewritten
     at epoch E — LAST, so its epoch never names a partially-durable
     commit;
  4. journals cleared.

Recovery (``recover_journal``, duck-typed by ChainstateManager exactly
like the single-shard store): journals all valid at epoch E -> replay
every shard (idempotent) and rewrite the manifest at E; journals partial/
torn -> the crash hit inside step 1, no shard applied anything -> discard
the fragments (rollback; the manifest still names the previous epoch).
Either way every shard lands on ONE consistent epoch — verified by the
sharded hard-kill drill in tests/unit/test_crashsafe_store.py.

Each shard also maintains a MuHash accumulator over its coin rows
(meta row ``b"M"``; store/muhash.py) updated with the commit's batch
delta — the global UTXO-set digest is the product of the shard
accumulators, independent of the shard count, and is what snapshots
stamp and ``gettxoutsetinfo`` surfaces.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from ..consensus.tx import COutPoint
from ..util import telemetry as tm
from ..util.faults import INJECTOR, maybe_crash
from ..util.log import log_printf
from ..validation.coins import Coin, CoinsView
from . import muhash
from .chainstatedb import (
    _BEST,
    _COIN,
    _NULL_HASH,
    _coin_key,
    _decode_journal,
    _encode_journal,
    CoinsDB,
)
from .kvstore import KVStore, atomic_write_bytes, atomic_write_json, read_json

# The parallel-flush fault site (util/faults.py STORE_SHARD_SITE):
# explicit-only, fires at the head of every shard's journal leg.
STORE_SHARD_SITE = "store_shard"

_EPOCH = b"E"          # per-shard meta: LE64 commit epoch
_ACC = b"M"            # per-shard meta: 384-byte BE MuHash accumulator
MANIFEST_NAME = "chainstate.manifest.json"

_FLUSH_HIST = tm.histogram(
    "bcp_store_flush_seconds",
    "per-shard chainstate apply+fsync latency inside one parallel flush",
    labels=("shard",),
)
_SHARD_BYTES = tm.gauge(
    "bcp_store_shard_bytes",
    "on-disk bytes per chainstate shard (sqlite main + WAL)",
    labels=("shard",),
)


def shard_of(key36: bytes, n_shards: int) -> int:
    """Hash partition of a 36-byte outpoint key (power-of-two n_shards)."""
    return zlib.crc32(key36) & (n_shards - 1)


class _KeyBloom:
    """Write-side membership filter over a shard's coin keys (ISSUE 20
    satellite, BENCH_r12 follow-up).

    The accumulator delta must divide out every changed row's PERSISTED
    old value — which costs a point lookup per changed key even when the
    key was never persisted (the common case under flood: fresh coin
    creates). The bloom answers "definitely absent" for those keys so
    they skip ``get_serialized_many`` entirely; a maybe-present answer
    falls through to the lookup, so a false positive costs only the old
    price and a false negative is impossible (every persisted key was
    ``add``-ed at its own commit, or at the lazy build scan).

    No hash functions: outpoint keys are txid (32 uniformly random
    bytes) + LE32 vout, so the probes are four 8-byte windows of the key
    itself, each XOR-mixed with an odd-constant multiple of the vout
    word (outputs of one tx share all 32 txid bytes — without the mix
    they would share all four probes). Deterministic across processes
    (no PYTHONHASHSEED), vectorized across the whole batch.
    """

    __slots__ = ("m_bits", "mask", "bits", "added")

    _MIX = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
            0x165667B19E3779F9, 0x27D4EB2F165667C5)

    def __init__(self, m_bits: int):
        # power-of-two bit count; ~1 MiB per 2^23 bits
        self.m_bits = m_bits
        self.mask = np.uint64(m_bits - 1)
        self.bits = np.zeros(m_bits // 8, dtype=np.uint8)
        self.added = 0

    @classmethod
    def sized(cls, n_keys: int) -> "_KeyBloom":
        """~16 bits/key (4 probes -> ~0.2% FP), 1 Mi-bit floor."""
        m = 1 << 20
        while m < 16 * max(n_keys, 1):
            m *= 2
        return cls(m)

    def _probes(self, keys: list[bytes]) -> list[np.ndarray]:
        flat = np.frombuffer(b"".join(keys), dtype=np.uint8)
        k = flat.reshape(-1, 36)
        vout = k[:, 32:36].copy().view(np.uint32).ravel().astype(np.uint64)
        out = []
        with np.errstate(over="ignore"):
            for j, mix in enumerate(self._MIX):
                w = k[:, 8 * j:8 * j + 8].copy().view(np.uint64).ravel()
                out.append((w ^ (vout * np.uint64(mix))) & self.mask)
        return out

    def add_many(self, keys: list[bytes]) -> None:
        if not keys:
            return
        for probe in self._probes(keys):
            np.bitwise_or.at(
                self.bits, probe >> np.uint64(3),
                np.left_shift(np.uint8(1),
                              (probe & np.uint64(7)).astype(np.uint8)))
        self.added += len(keys)

    def filter(self, keys: list[bytes]) -> list[bytes]:
        """The maybe-present subset of ``keys`` (order preserved)."""
        if not keys:
            return keys
        hit = np.ones(len(keys), dtype=bool)
        for probe in self._probes(keys):
            hit &= (self.bits[probe >> np.uint64(3)]
                    >> (probe & np.uint64(7)).astype(np.uint8)) & 1 > 0
        if bool(hit.all()):
            return keys
        return [k for k, h in zip(keys, hit) if h]

    def saturated(self) -> bool:
        """Adds can only set bits; past ~m/8 keys the FP rate climbs
        toward useless (~2%) — the owner rebuilds bigger from the
        persisted rows."""
        return self.added > self.m_bits // 8


def _shard_paths(datadir: str, i: int) -> tuple[str, str]:
    return (os.path.join(datadir, f"chainstate.shard{i}.sqlite"),
            os.path.join(datadir, f"chainstate.shard{i}.journal"))


class ShardedCoinsDB(CoinsView):
    """The facade: CoinsDB-compatible surface over N shard backends."""

    def __init__(self, datadir: str, n_shards: int = 4, wal: bool = False):
        if n_shards < 1 or n_shards > 256 or (n_shards & (n_shards - 1)):
            raise ValueError(
                f"n_shards={n_shards}: must be a power of two in [1, 256]")
        self.datadir = datadir
        os.makedirs(datadir, exist_ok=True)
        self.manifest_path = os.path.join(datadir, MANIFEST_NAME)
        manifest = read_json(self.manifest_path)
        # an existing store's shard count is a property of the on-disk
        # layout, not of the flag: the manifest wins on reopen
        self.requested_shards = n_shards
        if manifest and int(manifest.get("shards", n_shards)) != n_shards:
            n_shards = int(manifest["shards"])
        self.n_shards = n_shards
        # -coinswal: per-shard WAL commit discipline (store/kvstore) —
        # sync'd shard batches fsync the WAL at COMMIT instead of running
        # a full checkpoint each flush. Operational knob, not layout: the
        # manifest does not pin it, so it can be toggled per restart.
        self.wal = wal
        self.shards: list[CoinsDB] = []
        for i in range(n_shards):
            db_path, journal_path = _shard_paths(datadir, i)
            self.shards.append(
                CoinsDB(KVStore(db_path, wal=wal),
                        journal_path=journal_path))
        self._pool = (ThreadPoolExecutor(
            max_workers=n_shards, thread_name_prefix="coins-shard")
            if n_shards > 1 else None)
        self._accs = [muhash.MuHash.from_bytes(s.kv.get(_ACC))
                      for s in self.shards]
        self._epoch = int(manifest["epoch"]) if manifest else \
            self._max_shard_epoch()
        self._snapshot_state = (manifest or {}).get("snapshot")
        # write-side blooms (ISSUE 20 satellite): per-shard, in-memory
        # only, built lazily at each shard's first commit from the
        # persisted keys; BCP_STORE_BLOOM=0 disables (the A/B knob the
        # utxo_store bench sweeps)
        self.bloom_enabled = os.environ.get("BCP_STORE_BLOOM", "1") != "0"
        self._blooms: list[Optional[_KeyBloom]] = [None] * n_shards
        self.bloom_stats = {"checked": 0, "skipped": 0, "builds": 0,
                            "rebuilds": 0}
        self.last_flush = {"fanout": 0, "seconds": 0.0, "coins": 0,
                           "per_shard_s": []}

    # -- meta helpers ----------------------------------------------------

    def _shard_epoch(self, i: int) -> int:
        raw = self.shards[i].kv.get(_EPOCH)
        return struct.unpack("<Q", raw)[0] if raw else 0

    def _max_shard_epoch(self) -> int:
        return max(self._shard_epoch(i) for i in range(self.n_shards))

    @property
    def epoch(self) -> int:
        return self._epoch

    def muhash_state(self) -> int:
        return muhash.combine(a.state for a in self._accs)

    def muhash_digest(self) -> bytes:
        return muhash.digest_of(self.muhash_state())

    def _write_manifest(self) -> None:
        doc = {
            "version": 1,
            "shards": self.n_shards,
            "epoch": self._epoch,
            "best_block": self.best_block()[::-1].hex(),
            "muhash": self.muhash_digest().hex(),
        }
        if self._snapshot_state is not None:
            doc["snapshot"] = self._snapshot_state
        atomic_write_json(self.manifest_path, doc)

    @property
    def snapshot_state(self) -> Optional[dict]:
        """The assumeutxo onboarding record stamped into the manifest by
        loadtxoutset ({height, hash, digest, validated}); None when this
        chainstate was built by normal IBD."""
        return self._snapshot_state

    def set_snapshot_state(self, state: Optional[dict]) -> None:
        self._snapshot_state = state
        self._write_manifest()

    # -- the commit protocol ---------------------------------------------

    def _commit_sharded(self, entries, best_block: bytes) -> None:
        """entries: iterable of (key36, coin_ser | None-for-delete)."""
        per_puts: list[dict] = [{} for _ in range(self.n_shards)]
        per_dels: list[list] = [[] for _ in range(self.n_shards)]
        n_coins = 0
        for k, ser in entries:
            n_coins += 1
            if ser is None:
                per_dels[shard_of(k, self.n_shards)].append(k)
            else:
                per_puts[shard_of(k, self.n_shards)][k] = ser
        epoch = self._epoch + 1

        # accumulator batch delta, per shard: divide out every changed
        # row's PERSISTED old value (overwrites and spends alike; a
        # tombstone for a never-persisted coin has no old row and costs
        # nothing), multiply in the new values. One modular inverse per
        # shard per commit (muhash.MuHash.apply).
        new_accs = []
        flush_bloom = {"checked": 0, "skipped": 0}
        for i in range(self.n_shards):
            changed = list(per_puts[i]) + per_dels[i]
            # bloom pre-pass: keys the filter proves absent (fresh coin
            # creates, the flood-common case) skip the old-value lookup;
            # false positives just pay the lookup, false negatives are
            # impossible (every persisted key passed through add_many)
            if changed and self.bloom_enabled:
                maybe = self._bloom_for(i).filter(changed)
                flush_bloom["checked"] += len(changed)
                flush_bloom["skipped"] += len(changed) - len(maybe)
            else:
                maybe = changed
            old = self.shards[i].get_serialized_many(maybe) if maybe \
                else {}
            removed = [muhash.coin_element(k, old[k])
                       for k in changed if k in old]
            added = [muhash.coin_element(k, ser)
                     for k, ser in per_puts[i].items()]
            acc = muhash.MuHash(self._accs[i].state)
            acc.apply(added, removed)
            new_accs.append(acc)
            if self.bloom_enabled and per_puts[i]:
                # the new puts become persisted rows below — future
                # commits must see them as maybe-present
                self._bloom_for(i).add_many(list(per_puts[i]))
        self.bloom_stats["checked"] += flush_bloom["checked"]
        self.bloom_stats["skipped"] += flush_bloom["skipped"]

        meta_epoch = struct.pack("<Q", epoch)
        kv_puts = []
        kv_dels = []
        for i in range(self.n_shards):
            puts = {_COIN + k: v for k, v in per_puts[i].items()}
            puts[_BEST] = best_block
            puts[_EPOCH] = meta_epoch
            puts[_ACC] = new_accs[i].to_bytes()
            kv_puts.append(puts)
            kv_dels.append([_COIN + k for k in per_dels[i]])

        # step 1: journals durable, sequentially. A failure here (the
        # store_shard fault site included) aborts the whole commit and
        # unlinks every journal already written this epoch — no shard is
        # ever ahead of the manifest.
        written = []
        try:
            for i, shard in enumerate(self.shards):
                INJECTOR.on_call(STORE_SHARD_SITE)
                atomic_write_bytes(shard.journal_path,
                                   _encode_journal(kv_puts[i], kv_dels[i]))
                maybe_crash("journal:durable")
                written.append(shard.journal_path)
        except BaseException:
            for p in written:
                if os.path.exists(p):
                    os.unlink(p)
            raise
        maybe_crash("shard:journals-durable")

        # step 2: parallel applies. From here the commit only rolls
        # FORWARD — an error leaves the journals in place for replay.
        t0 = time.perf_counter()
        per_shard_s = [0.0] * self.n_shards

        def _apply(i: int) -> None:
            ta = time.perf_counter()
            self.shards[i].kv.write_batch(kv_puts[i], kv_dels[i], sync=True)
            dt = time.perf_counter() - ta
            per_shard_s[i] = dt
            _FLUSH_HIST.labels(shard=str(i)).observe(dt)

        if self._pool is not None:
            futures = [self._pool.submit(_apply, i)
                       for i in range(self.n_shards)]
            for f in futures:
                f.result()
        else:
            _apply(0)
        maybe_crash("shard:applied")

        # step 3: the cross-shard epoch marker, written last
        self._accs = new_accs
        self._epoch = epoch
        self._write_manifest()
        maybe_crash("manifest:written")

        # step 4: clear
        for shard in self.shards:
            maybe_crash("journal:pre-clear")
            if os.path.exists(shard.journal_path):
                os.unlink(shard.journal_path)

        self.last_flush = {
            "fanout": self.n_shards,
            "seconds": time.perf_counter() - t0,
            "coins": n_coins,
            "per_shard_s": [round(s, 6) for s in per_shard_s],
            "bloom": flush_bloom,
        }
        for i in range(self.n_shards):
            _SHARD_BYTES.labels(shard=str(i)).set(self.shard_bytes(i))

    def recover_journal(self) -> bool:
        """Startup replay/rollback across every shard, landing all of
        them on one epoch. Called by ChainstateManager.__init__ via the
        same duck-typed hook as the single-shard store."""
        for p in (self.manifest_path + ".tmp",):
            if os.path.exists(p):
                os.unlink(p)
        decoded: list[Optional[tuple]] = []
        for shard in self.shards:
            tmp = shard.journal_path + ".tmp"
            if os.path.exists(tmp):
                os.unlink(tmp)  # pre-durability fragment
            if not os.path.exists(shard.journal_path):
                decoded.append(None)
                continue
            with open(shard.journal_path, "rb") as f:
                data = f.read()
            d = _decode_journal(data)
            if d is None:
                log_printf("shard journal torn (%s) — rolling back",
                           os.path.basename(shard.journal_path))
                os.unlink(shard.journal_path)
            decoded.append(d)
        if not any(d is not None for d in decoded):
            return False

        valid = [d for d in decoded if d is not None]
        epoch = struct.unpack("<Q", valid[0][0][_EPOCH])[0]
        if len(valid) < self.n_shards:
            # partial journal set: the crash hit while step 1 was still
            # writing journals — unless a journal-less shard already
            # carries epoch E, in which case the journals vanished in
            # step 4 and the valid remainder just replays.
            applied_without_journal = any(
                decoded[i] is None and self._shard_epoch(i) >= epoch
                for i in range(self.n_shards))
            if not applied_without_journal:
                if any(self._shard_epoch(i) >= epoch
                       for i in range(self.n_shards)):
                    # a shard reached epoch E while a journal-less peer is
                    # still behind it: impossible under the step order
                    # (applies only start once EVERY journal is durable)
                    raise RuntimeError(
                        "sharded chainstate inconsistent: shard ahead of "
                        "a journal-less peer")
                for i, d in enumerate(decoded):
                    if d is not None and \
                            os.path.exists(self.shards[i].journal_path):
                        os.unlink(self.shards[i].journal_path)
                log_printf("sharded commit rolled back: %d/%d journals "
                           "durable at epoch %d", len(valid), self.n_shards,
                           epoch)
                return False
        # replay: every journal present (or the absent ones already
        # applied + cleared). Idempotent per shard.
        n_puts = n_dels = 0
        for i, d in enumerate(decoded):
            if d is None:
                continue
            puts, dels = d
            self.shards[i].kv.write_batch(puts, dels, sync=True)
            n_puts += len(puts)
            n_dels += len(dels)
        self._accs = [muhash.MuHash.from_bytes(s.kv.get(_ACC))
                      for s in self.shards]
        self._epoch = epoch
        self._write_manifest()
        for i, d in enumerate(decoded):
            if d is not None and \
                    os.path.exists(self.shards[i].journal_path):
                os.unlink(self.shards[i].journal_path)
        log_printf("sharded journal replayed at epoch %d: %d put(s), "
                   "%d delete(s) across %d shard(s)",
                   epoch, n_puts, n_dels, self.n_shards)
        return True

    # -- CoinsDB-compatible surface --------------------------------------

    def _bloom_for(self, i: int) -> _KeyBloom:
        """The shard's bloom, built at first use from the persisted keys
        (one full key scan per shard per process) and rebuilt bigger
        when adds saturate it."""
        b = self._blooms[i]
        if b is not None and b.saturated():
            self.bloom_stats["rebuilds"] += 1
            b = None
        if b is None:
            keys = [k for k, _ in self.iterate_shard_coins(i)]
            b = _KeyBloom.sized(max(len(keys) * 2, 1))
            b.add_many(keys)
            self._blooms[i] = b
            self.bloom_stats["builds"] += 1
        return b

    def _shard_for(self, key36: bytes) -> CoinsDB:
        return self.shards[shard_of(key36, self.n_shards)]

    def get_coin(self, outpoint: COutPoint) -> Optional[Coin]:
        return self._shard_for(_coin_key(outpoint)[1:]).get_coin(outpoint)

    def have_coin(self, outpoint: COutPoint) -> bool:
        return self._shard_for(_coin_key(outpoint)[1:]).have_coin(outpoint)

    def best_block(self) -> bytes:
        return self.shards[0].kv.get(_BEST) or _NULL_HASH

    def batch_write(self, coins: dict, best_block: bytes) -> None:
        self._commit_sharded(
            ((op.hash + struct.pack("<I", op.n),
              None if coin is None else coin.serialize())
             for op, coin in coins.items()),
            best_block)

    def batch_write_serialized(self, entries, best_block: bytes) -> None:
        self._commit_sharded(entries, best_block)

    def get_serialized_many(self, keys36: list[bytes]) -> dict[bytes, bytes]:
        per: list[list[bytes]] = [[] for _ in range(self.n_shards)]
        for k in keys36:
            per[shard_of(k, self.n_shards)].append(k)
        out: dict[bytes, bytes] = {}
        for i, keys in enumerate(per):
            if keys:
                out.update(self.shards[i].get_serialized_many(keys))
        return out

    def count_coins(self) -> int:
        return sum(s.count_coins() for s in self.shards)

    def iterate_coins(self) -> Iterator[tuple[bytes, bytes]]:
        """(key36, coin_ser) over every shard — shard-major order; the
        consumers (gettxoutsetinfo, snapshot dump, digest recompute) are
        order-independent."""
        for shard in self.shards:
            for k, v in shard.kv.iterate(_COIN):
                yield k[1:], v

    def iterate_shard_coins(self, i: int) -> Iterator[tuple[bytes, bytes]]:
        for k, v in self.shards[i].kv.iterate(_COIN):
            yield k[1:], v

    # -- snapshot bulk load ----------------------------------------------

    def ingest_rows(self, rows: list[tuple[bytes, bytes]]) -> None:
        """Journal-less bulk insert for snapshot onboarding (the caller
        finalizes with meta + manifest once the digest verifies)."""
        per: list[dict] = [{} for _ in range(self.n_shards)]
        for k, ser in rows:
            per[shard_of(k, self.n_shards)][_COIN + k] = ser

        def _load(i: int) -> None:
            if per[i]:
                self.shards[i].kv.write_batch(per[i])

        if self._pool is not None:
            for f in [self._pool.submit(_load, i)
                      for i in range(self.n_shards)]:
                f.result()
        else:
            _load(0)
        # bulk rows bypassed the commit path: rebuild lazily on next use
        self._blooms = [None] * self.n_shards

    def clear_coins(self) -> None:
        """Drop every coin row (failed snapshot load cleanup)."""
        for shard in self.shards:
            dels = [k for k, _ in shard.kv.iterate(_COIN)]
            for i in range(0, len(dels), 10000):
                shard.kv.write_batch({}, dels[i:i + 10000])
        self._blooms = [None] * self.n_shards

    def finalize_bulk_load(self, best_block: bytes,
                           shard_states: list[int],
                           snapshot: Optional[dict] = None) -> None:
        """Stamp meta rows + manifest after a verified bulk load."""
        assert len(shard_states) == self.n_shards
        epoch = self._epoch + 1
        meta_epoch = struct.pack("<Q", epoch)
        for i, shard in enumerate(self.shards):
            shard.kv.write_batch({
                _BEST: best_block,
                _EPOCH: meta_epoch,
                _ACC: muhash.MuHash(shard_states[i]).to_bytes(),
            }, sync=True)
        self._accs = [muhash.MuHash(s) for s in shard_states]
        self._epoch = epoch
        self._snapshot_state = snapshot
        self._write_manifest()

    # -- observability ---------------------------------------------------

    def shard_bytes(self, i: int) -> int:
        db_path, _ = _shard_paths(self.datadir, i)
        total = 0
        for suffix in ("", "-wal"):
            try:
                total += os.path.getsize(db_path + suffix)
            except OSError:
                pass
        return total

    def recompute_digest(self) -> bytes:
        """From-scratch digest over the persisted rows (test oracle for
        the incrementally-maintained accumulator)."""
        elems = [muhash.coin_element(k, v) for k, v in self.iterate_coins()]
        return muhash.digest_of(muhash.batch_product(elems))

    def stats(self) -> dict:
        return {
            "shards": self.n_shards,
            "wal": self.wal,
            "epoch": self._epoch,
            "muhash": self.muhash_digest().hex(),
            "bloom": {"enabled": self.bloom_enabled, **self.bloom_stats},
            "last_flush": dict(self.last_flush),
            "shard_bytes": [self.shard_bytes(i)
                            for i in range(self.n_shards)],
            "snapshot": self._snapshot_state,
        }

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for shard in self.shards:
            shard.kv.close()

    @staticmethod
    def wipe(datadir: str) -> None:
        """Remove every shard/manifest artifact (the -reindex wipe)."""
        import glob as _glob

        for p in _glob.glob(os.path.join(datadir, "chainstate.shard*")):
            os.remove(p)
        for p in (os.path.join(datadir, MANIFEST_NAME),
                  os.path.join(datadir, MANIFEST_NAME + ".tmp")):
            if os.path.exists(p):
                os.remove(p)
