"""Coins DB and block-index DB over the KV store.

Reference: src/txdb.{h,cpp} — CCoinsViewDB ('chainstate' LevelDB: key
DB_COIN 'C' + outpoint, value Coin; DB_BEST_BLOCK 'B' marker) and
CBlockTreeDB ('blocks/index': DB_BLOCK_INDEX 'b' + hash -> CDiskBlockIndex,
DB_BLOCK_FILES, DB_REINDEX_FLAG, DB_FLAG for -txindex).

The coins schema here stores one row per outpoint (the 0.15+ per-output
model, not 0.14's per-tx CCoins) — better granularity for flush batching.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional

from ..consensus.block import CBlockHeader
from ..consensus.serialize import ByteReader
from ..consensus.tx import COutPoint
from ..util.faults import maybe_crash
from ..util.log import log_printf
from ..validation.coins import Coin, CoinsView
from .kvstore import KVStore, atomic_write_bytes

_COIN = b"C"
_BEST = b"B"
_BLOCK_INDEX = b"b"
_BLOCK_POS = b"f"
_UNDO_POS = b"u"
_FLAG = b"F"
_NULL_HASH = b"\x00" * 32


def _coin_key(op: COutPoint) -> bytes:
    return _COIN + op.hash + struct.pack("<I", op.n)


# ---------------------------------------------------------------------------
# Commit journal — the crash-safety layer for block connect/disconnect.
#
# Every coins batch (spends + creates + best-block marker) is first made
# durable as a self-checksummed journal file (fsync-before-rename,
# kvstore.atomic_write_bytes), then applied to sqlite, then the journal is
# cleared. On startup (ChainstateManager.__init__ -> recover_journal):
#   - valid journal present  -> the crash hit between durability and clear:
#     REPLAY the batch (puts/deletes are idempotent) -> post-block state;
#   - torn/absent journal    -> the crash hit before durability: discard the
#     fragment (ROLLBACK)    -> pre-block state, sqlite untouched or its
#     uncommitted transaction self-discarded by WAL recovery.
# Either way the reopened UTXO set is exactly pre- or post-block, never a
# torn mix — verified by the crash-injection tests killing the process at
# every step (tests/unit/test_crashsafe_store.py).
# ---------------------------------------------------------------------------

_JOURNAL_MAGIC = b"BCPJ1"


def _encode_journal(puts: dict[bytes, bytes], deletes: list[bytes]) -> bytes:
    body = [struct.pack("<I", len(puts))]
    for k, v in puts.items():
        body.append(struct.pack("<I", len(k)) + k)
        body.append(struct.pack("<I", len(v)) + v)
    body.append(struct.pack("<I", len(deletes)))
    for k in deletes:
        body.append(struct.pack("<I", len(k)) + k)
    blob = b"".join(body)
    return _JOURNAL_MAGIC + struct.pack("<I", zlib.crc32(blob)) + blob


def _decode_journal(data: bytes):
    """(puts, deletes) or None for anything torn/corrupt (short file, bad
    magic, bad checksum, truncated record)."""
    if len(data) < 9 or data[:5] != _JOURNAL_MAGIC:
        return None
    (crc,) = struct.unpack_from("<I", data, 5)
    blob = data[9:]
    if zlib.crc32(blob) != crc:
        return None
    try:
        pos = 0

        def take(n: int) -> bytes:
            nonlocal pos
            if pos + n > len(blob):
                raise ValueError("truncated journal")
            out = blob[pos:pos + n]
            pos += n
            return out

        (n_puts,) = struct.unpack("<I", take(4))
        puts: dict[bytes, bytes] = {}
        for _ in range(n_puts):
            (klen,) = struct.unpack("<I", take(4))
            k = take(klen)
            (vlen,) = struct.unpack("<I", take(4))
            puts[k] = take(vlen)
        (n_dels,) = struct.unpack("<I", take(4))
        deletes = []
        for _ in range(n_dels):
            (klen,) = struct.unpack("<I", take(4))
            deletes.append(take(klen))
        return puts, deletes
    except (ValueError, struct.error):
        return None


class CoinsDB(CoinsView):
    """CCoinsViewDB — the persistent bottom of the view stack.

    With ``journal_path`` set, every batch commit is journaled (see the
    commit-journal block above) so a crash mid-commit can always be
    resolved to a whole pre- or post-batch state at reopen."""

    def __init__(self, kv: KVStore, journal_path: Optional[str] = None):
        self.kv = kv
        self.journal_path = journal_path

    def _commit(self, puts: dict[bytes, bytes], deletes: list[bytes]) -> None:
        """The journaled write path shared by batch_write and
        batch_write_serialized. Step order IS the crash-safety contract:
        (1) journal durable, (2) DB apply, (3) journal clear."""
        if self.journal_path is not None:
            atomic_write_bytes(self.journal_path,
                              _encode_journal(puts, deletes))
            maybe_crash("journal:durable")
        self.kv.write_batch(puts, deletes, sync=True)
        maybe_crash("journal:pre-clear")
        if self.journal_path is not None and os.path.exists(self.journal_path):
            os.unlink(self.journal_path)

    def recover_journal(self) -> bool:
        """Startup replay/rollback (called by ChainstateManager.__init__
        before any chainstate read). Returns True when a valid journal was
        replayed. Replay is idempotent — a journal that was already fully
        applied before the crash re-applies to the same state."""
        if self.journal_path is None:
            return False
        stale_tmp = self.journal_path + ".tmp"
        if os.path.exists(stale_tmp):
            os.unlink(stale_tmp)  # pre-durability fragment: rollback
        if not os.path.exists(self.journal_path):
            return False
        with open(self.journal_path, "rb") as f:
            data = f.read()
        decoded = _decode_journal(data)
        if decoded is None:
            # torn journal: the commit never reached durability — the DB
            # still holds the whole pre-batch state; discard the fragment
            log_printf("chainstate journal torn — rolled back to the "
                       "pre-commit state")
            os.unlink(self.journal_path)
            return False
        puts, deletes = decoded
        self.kv.write_batch(puts, deletes, sync=True)
        os.unlink(self.journal_path)
        log_printf("chainstate journal replayed: %d put(s), %d delete(s)",
                   len(puts), len(deletes))
        return True

    def get_coin(self, outpoint: COutPoint) -> Optional[Coin]:
        raw = self.kv.get(_coin_key(outpoint))
        return Coin.deserialize(raw) if raw is not None else None

    def have_coin(self, outpoint: COutPoint) -> bool:
        """Existence probe without value fetch/deserialize — the BIP30
        pre-scan's per-output fast path (CoinsCache.have_coin)."""
        return self.kv.exists(_coin_key(outpoint))

    def best_block(self) -> bytes:
        return self.kv.get(_BEST) or _NULL_HASH

    def batch_write(self, coins: dict, best_block: bytes) -> None:
        puts: dict[bytes, bytes] = {}
        deletes: list[bytes] = []
        for op, coin in coins.items():
            if coin is None:
                deletes.append(_coin_key(op))
            else:
                puts[_coin_key(op)] = coin.serialize()
        puts[_BEST] = best_block
        # single transaction: coins + best-block marker move together —
        # the crash-consistency invariant (SURVEY.md §6.3); journaled when
        # a journal path is configured (crash at any step -> pre or post)
        self._commit(puts, deletes)

    def count_coins(self) -> int:
        return sum(1 for _ in self.kv.iterate(_COIN))

    def iterate_coins(self) -> Iterator[tuple[bytes, bytes]]:
        """(key36, coin_ser) rows — the facade-uniform iteration surface
        shared with ShardedCoinsDB (gettxoutsetinfo, snapshot dump)."""
        for k, v in self.kv.iterate(_COIN):
            yield k[1:], v

    # -- raw-key entry points for the native connect engine --------------
    # (native/connect.cpp speaks 36-byte outpoint keys + Coin.serialize
    # blobs; these avoid a COutPoint/Coin object round trip per row)

    def get_serialized_many(self, keys36: list[bytes]) -> dict[bytes, bytes]:
        """{key36: coin_serialization} for present rows (miss servicing)."""
        rows = self.kv.get_many([_COIN + k for k in keys36])
        return {k[1:]: v for k, v in rows.items()}

    def batch_write_serialized(self, entries, best_block: bytes) -> None:
        """entries: iterable of (key36, coin_ser | None-for-delete); one
        transaction with the best-block marker, same crash-consistency
        unit as batch_write."""
        puts: dict[bytes, bytes] = {}
        deletes: list[bytes] = []
        for k, ser in entries:
            if ser is None:
                deletes.append(_COIN + k)
            else:
                puts[_COIN + k] = ser
        puts[_BEST] = best_block
        self._commit(puts, deletes)


class BlockIndexDB:
    """CBlockTreeDB — headers + file positions + flags, enough to rebuild
    the in-memory block tree at startup (LoadBlockIndexDB)."""

    def __init__(self, kv: KVStore):
        self.kv = kv

    def put_index_batch(self, entries: list) -> None:
        """entries: (hash, header80, height, status, n_tx, blkpos, undopos)."""
        puts = {}
        for h, header80, height, status, n_tx, blkpos, undopos in entries:
            puts[_BLOCK_INDEX + h] = (
                header80
                + struct.pack("<iII", height, status, n_tx)
                + struct.pack("<iii", *(blkpos or (-1, -1, -1)))
                + struct.pack("<iii", *(undopos or (-1, -1, -1)))
            )
        self.kv.write_batch(puts)

    def iterate_index(self) -> Iterator[tuple]:
        """Yields (hash, CBlockHeader, height, status, n_tx, blkpos, undopos)."""
        for k, v in self.kv.iterate(_BLOCK_INDEX):
            h = k[1:]
            header = CBlockHeader.deserialize(ByteReader(v[:80]))
            height, status, n_tx = struct.unpack("<iII", v[80:92])
            blkpos = struct.unpack("<iii", v[92:104])
            undopos = struct.unpack("<iii", v[104:116])
            yield (
                h,
                header,
                height,
                status,
                n_tx,
                None if blkpos[0] < 0 else blkpos,
                None if undopos[0] < 0 else undopos,
            )

    def put_flag(self, name: bytes, value: bool) -> None:
        self.kv.put(_FLAG + name, b"1" if value else b"0")

    def get_flag(self, name: bytes) -> bool:
        return self.kv.get(_FLAG + name) == b"1"
