"""mempool.dat — dump/load the mempool across restarts.

Reference: src/validation.cpp (DumpMempool / LoadMempool, 0.14+). Same
shape: a version field, the entries as (tx, entry time, fee delta), then
the surviving mapDeltas for txs not currently in the pool. Entries are
written parents-first (sorted by in-pool ancestor count, the reference's
GetSortedDepthAndScore ordering) so a straight replay through
AcceptToMemoryPool re-admits chains without an orphan pass.
"""

from __future__ import annotations

import os
import struct
import time as _time
from typing import Optional

from ..consensus.serialize import (
    ByteReader,
    DeserializationError,
    deser_i64,
    deser_u64,
    ser_compact_size,
)
from ..consensus.tx import CTransaction
from ..util.log import log_printf
from .mempool import CTxMemPool, MempoolError

MEMPOOL_DUMP_VERSION = 1


def dump_mempool(pool: CTxMemPool, path: str) -> int:
    """Write pool contents + fee deltas to ``path`` atomically (write to
    .new then rename, like the reference). Returns the entry count."""
    entries = sorted(pool.entries.values(),
                     key=lambda e: e.count_with_ancestors)
    blob = [struct.pack("<Q", MEMPOOL_DUMP_VERSION),
            struct.pack("<Q", len(entries))]
    for e in entries:
        blob.append(e.tx.serialize())
        blob.append(struct.pack("<qq", e.time,
                                pool.map_deltas.get(e.txid, 0)))
    leftover = {txid: delta for txid, delta in pool.map_deltas.items()
                if txid not in pool.entries and delta != 0}
    blob.append(ser_compact_size(len(leftover)))
    for txid, delta in leftover.items():
        blob.append(txid)
        blob.append(struct.pack("<q", delta))
    tmp = path + ".new"
    with open(tmp, "wb") as f:
        f.write(b"".join(blob))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(entries)


def load_mempool(node, path: str,
                 now: Optional[int] = None) -> tuple[int, int, int]:
    """Replay ``path`` through the node's AcceptToMemoryPool. Returns
    (accepted, failed, expired). Unreadable/corrupt files are logged and
    skipped — a bad mempool.dat must never stop the node (reference
    behavior)."""
    if not os.path.exists(path):
        return (0, 0, 0)
    now = int(_time.time()) if now is None else now
    accepted = failed = expired = 0
    try:
        with open(path, "rb") as f:
            r = ByteReader(f.read())
        version = deser_u64(r)
        if version != MEMPOOL_DUMP_VERSION:
            log_printf("mempool.dat: unknown version %d, ignoring", version)
            return (0, 0, 0)
        count = deser_u64(r)
        for _ in range(count):
            tx = CTransaction.deserialize(r)
            entry_time = deser_i64(r)
            delta = deser_i64(r)
            if delta:
                node.mempool.map_deltas[tx.txid] = (
                    node.mempool.map_deltas.get(tx.txid, 0) + delta)
            if entry_time < now - node.mempool.expiry_seconds:
                expired += 1
                continue
            try:
                node.accept_to_mempool(tx, now=entry_time,
                       fee_estimate=False)
                accepted += 1
            except MempoolError:
                failed += 1
        from ..consensus.serialize import deser_compact_size

        n_deltas = deser_compact_size(r)
        for _ in range(n_deltas):
            txid = r.read_bytes(32)
            delta = deser_i64(r)
            node.mempool.map_deltas[txid] = (
                node.mempool.map_deltas.get(txid, 0) + delta)
    except (DeserializationError, struct.error, ValueError, OSError) as e:
        log_printf("mempool.dat: corrupt (%r), continuing with partial load", e)
    log_printf("mempool.dat: %d accepted, %d failed, %d expired",
               accepted, failed, expired)
    return (accepted, failed, expired)
