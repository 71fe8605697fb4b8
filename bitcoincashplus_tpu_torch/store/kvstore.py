"""CDBWrapper-shaped key-value store over sqlite3.

Reference: src/dbwrapper.{h,cpp} (CDBWrapper, CDBBatch, CDBIterator) over
LevelDB. sqlite3 (WAL mode) provides the same contract this framework needs:
ordered byte-key iteration, atomic batch writes, durable sync on request.
The obfuscation-key machinery of the reference (anti-virus false-positive
mitigation) is intentionally dropped — it has no behavioral surface.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Iterator, Optional

from ..util import lockwatch
from ..util.faults import maybe_crash


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durable file publish with fsync-before-rename semantics: write to a
    sibling .tmp, flush+fsync the data, atomically rename over ``path``,
    then fsync the directory so the rename itself is durable. A crash at
    any point leaves either the old file (or no file) or the complete new
    one — never a torn write. Used by the chainstate commit journal
    (store/chainstatedb.py). Crash points (util/faults.maybe_crash) let
    tests kill the process between each step."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    maybe_crash("journal:tmp-written")
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def atomic_write_json(path: str, obj) -> None:
    """JSON flavor of :func:`atomic_write_bytes` — the durable publish used
    by the small operational sidecar files (banlist.json, like the
    reference's banman.cpp DumpBanlist)."""
    atomic_write_bytes(
        path, json.dumps(obj, sort_keys=True, indent=1).encode()
    )


def read_json(path: str, default=None):
    """Load a JSON sidecar written by :func:`atomic_write_json`; a missing
    or corrupt file yields ``default`` (startup must never die on an
    operational sidecar — the reference logs and recreates banlist.dat)."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return default


class KVStore:
    def __init__(self, path: str, wal: bool = False):
        # isolation_level=None -> explicit transaction control.
        # check_same_thread=False: RPC worker threads reach the store.
        # Most access serializes under the node's cs_main, but not ALL of
        # it — node INIT keeps working while the background txindex
        # backfill thread writes under cs_main, and two overlapping
        # BEGIN/COMMIT spans on ONE sqlite connection raise ("cannot start
        # a transaction within a transaction"). The store owns its write
        # lock so atomicity never depends on every caller's locking.
        # Named per-file in the lockwatch graph so two stores' locks are
        # never conflated into a false ordering edge.
        self._write_lock = lockwatch.watched_lock(
            "kvstore:%s" % os.path.basename(path))
        self._db = sqlite3.connect(path, isolation_level=None,
                                   check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        # wal=False (default): synchronous=NORMAL + an explicit
        # wal_checkpoint(FULL) on every sync'd batch — the checkpoint IS
        # the durability boundary. wal=True (-coinswal): the WAL itself
        # is the durability boundary — synchronous=FULL makes each COMMIT
        # fsync the WAL, sync'd batches skip the (expensive, serializing)
        # per-commit checkpoint, and sqlite's auto-checkpoint folds the
        # WAL back at its leisure. Committed transactions are equally
        # durable either way; the knob trades checkpoint latency in the
        # parallel per-shard flush for WAL-fsync latency at commit.
        self.wal = wal
        self._db.execute("PRAGMA synchronous=%s"
                         % ("FULL" if wal else "NORMAL"))
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
        )

    def get(self, key: bytes) -> Optional[bytes]:
        row = self._db.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def get_many(self, keys: list[bytes]) -> dict[bytes, bytes]:
        """Present rows for ``keys`` in one query per 500 keys (sqlite's
        bound-parameter limit is 999) — the block-import miss-fetch path."""
        out: dict[bytes, bytes] = {}
        for i in range(0, len(keys), 500):
            chunk = keys[i:i + 500]
            q = ("SELECT k, v FROM kv WHERE k IN (%s)"
                 % ",".join("?" * len(chunk)))
            for k, v in self._db.execute(q, chunk):
                out[k] = v
        return out

    def put(self, key: bytes, value: bytes) -> None:
        # under the write lock: a lone put during another thread's open
        # BEGIN would otherwise join (and possibly roll back with) that
        # transaction on this shared connection — ADVICE r4
        with self._write_lock:
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (key, value),
            )

    def delete(self, key: bytes) -> None:
        with self._write_lock:
            self._db.execute("DELETE FROM kv WHERE k = ?", (key,))

    def exists(self, key: bytes) -> bool:
        return self.get(key) is not None

    def write_batch(self, puts: dict[bytes, bytes], deletes: list[bytes] = (),
                    sync: bool = False) -> None:
        """CDBBatch + WriteBatch: all-or-nothing (one sqlite transaction)."""
        with self._write_lock:
            cur = self._db.cursor()
            cur.execute("BEGIN")
            maybe_crash("kv:begin")
            try:
                if deletes:
                    cur.executemany("DELETE FROM kv WHERE k = ?",
                                    [(k,) for k in deletes])
                if puts:
                    cur.executemany(
                        "INSERT INTO kv (k, v) VALUES (?, ?) "
                        "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                        list(puts.items()),
                    )
                # a hard kill here leaves an uncommitted WAL transaction
                # that sqlite discards on reopen — the torn-commit case the
                # crash-injection tests cover
                maybe_crash("kv:applied")
                cur.execute("COMMIT")
                maybe_crash("kv:committed")
            except BaseException:
                cur.execute("ROLLBACK")
                raise
            if sync and not self.wal:
                self._db.execute("PRAGMA wal_checkpoint(FULL)")

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over keys with the given prefix — CDBIterator."""
        hi = _prefix_upper_bound(prefix) if prefix else None
        if prefix and hi is not None:
            cur = self._db.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k", (prefix, hi)
            )
        elif prefix:  # all-0xFF prefix: no finite upper bound
            cur = self._db.execute(
                "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (prefix,)
            )
        else:
            cur = self._db.execute("SELECT k, v FROM kv ORDER BY k")
        yield from cur

    def close(self) -> None:
        self._db.close()


def _prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every key starting with `prefix`
    (carry-increment, dropping trailing 0xFF bytes); None if prefix is all
    0xFF, which has no finite bound."""
    trimmed = prefix.rstrip(b"\xff")
    if not trimmed:
        return None
    return trimmed[:-1] + bytes([trimmed[-1] + 1])
