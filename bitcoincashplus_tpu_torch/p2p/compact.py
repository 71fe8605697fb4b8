"""BIP152 compact block relay structures.

Reference: src/blockencodings.{h,cpp} (CBlockHeaderAndShortTxIDs,
BlockTransactionsRequest, BlockTransactions, PartiallyDownloadedBlock),
protocol version 1 (no segwit in this lineage). Short IDs are
SipHash-2-4(txid) under a per-block key derived from the header+nonce,
truncated to 48 bits.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Optional

from ..consensus.block import CBlock, CBlockHeader
from ..consensus.serialize import (
    ByteReader,
    deser_compact_size,
    ser_compact_size,
)
from ..consensus.tx import CTransaction
from ..crypto.siphash import siphash24

SHORTID_MASK = 0xFFFFFFFFFFFF  # 48 bits


def short_id_keys(header: CBlockHeader, nonce: int) -> tuple[int, int]:
    """FillShortTxIDSelector: k0/k1 = first 16 bytes of
    SHA256(serialized header || le64(nonce))."""
    digest = hashlib.sha256(
        header.serialize() + struct.pack("<Q", nonce)
    ).digest()
    k0, k1 = struct.unpack_from("<QQ", digest, 0)
    return k0, k1


def short_id(k0: int, k1: int, txid: bytes) -> int:
    """GetShortID: SipHash-2-4 of the txid, truncated to 6 bytes."""
    return siphash24(k0, k1, txid) & SHORTID_MASK


class HeaderAndShortIDs:
    """cmpctblock payload (CBlockHeaderAndShortTxIDs)."""

    def __init__(self, header: CBlockHeader, nonce: int,
                 shortids: list[int],
                 prefilled: list[tuple[int, CTransaction]]):
        self.header = header
        self.nonce = nonce
        self.shortids = shortids
        self.prefilled = prefilled  # (absolute index, tx)

    @classmethod
    def from_block(cls, block: CBlock,
                   nonce: Optional[int] = None) -> "HeaderAndShortIDs":
        """Announce form: prefill only the coinbase (like the reference's
        default CBlockHeaderAndShortTxIDs constructor)."""
        if nonce is None:
            nonce = struct.unpack("<Q", os.urandom(8))[0]
        k0, k1 = short_id_keys(block.header, nonce)
        shortids = [short_id(k0, k1, tx.txid) for tx in block.vtx[1:]]
        return cls(block.header, nonce, shortids, [(0, block.vtx[0])])

    def serialize(self) -> bytes:
        out = [self.header.serialize(), struct.pack("<Q", self.nonce),
               ser_compact_size(len(self.shortids))]
        for sid in self.shortids:
            out.append(struct.pack("<Q", sid)[:6])
        out.append(ser_compact_size(len(self.prefilled)))
        last = -1
        for index, tx in self.prefilled:
            out.append(ser_compact_size(index - last - 1))  # differential
            out.append(tx.serialize())
            last = index
        return b"".join(out)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "HeaderAndShortIDs":
        header = CBlockHeader.deserialize(r)
        (nonce,) = struct.unpack("<Q", r.read_bytes(8))
        n = deser_compact_size(r)
        shortids = []
        for _ in range(n):
            shortids.append(
                struct.unpack("<Q", r.read_bytes(6) + b"\x00\x00")[0])
        n_pre = deser_compact_size(r)
        prefilled = []
        last = -1
        for _ in range(n_pre):
            diff = deser_compact_size(r)
            index = last + 1 + diff
            tx = CTransaction.deserialize(r)
            prefilled.append((index, tx))
            last = index
        return cls(header, nonce, shortids, prefilled)

    def total_tx_count(self) -> int:
        return len(self.shortids) + len(self.prefilled)

    def reconstruct(self, lookup) -> tuple[Optional[CBlock], list[int]]:
        """PartiallyDownloadedBlock::InitData + FillBlock: map short IDs to
        known txs via ``lookup`` (shortid -> CTransaction or None). Returns
        (block, []) when complete or (None, missing absolute indexes)."""
        k0, k1 = short_id_keys(self.header, self.nonce)
        total = self.total_tx_count()
        slots: list[Optional[CTransaction]] = [None] * total
        for index, tx in self.prefilled:
            if index >= total:
                return None, []
            slots[index] = tx
        sid_iter = iter(self.shortids)
        missing = []
        for i in range(total):
            if slots[i] is not None:
                continue
            sid = next(sid_iter)
            tx = lookup(sid)
            if tx is not None and short_id(k0, k1, tx.txid) == sid:
                slots[i] = tx
            else:
                missing.append(i)
        if missing:
            return None, missing
        block = CBlock(header=self.header, vtx=tuple(slots))
        return block, []


class BlockTransactionsRequest:
    """getblocktxn payload."""

    def __init__(self, block_hash: bytes, indexes: list[int]):
        self.block_hash = block_hash
        self.indexes = indexes  # absolute, ascending

    def serialize(self) -> bytes:
        out = [self.block_hash, ser_compact_size(len(self.indexes))]
        last = -1
        for i in self.indexes:
            out.append(ser_compact_size(i - last - 1))
            last = i
        return b"".join(out)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "BlockTransactionsRequest":
        block_hash = r.read_bytes(32)
        n = deser_compact_size(r)
        indexes = []
        last = -1
        for _ in range(n):
            diff = deser_compact_size(r)
            last = last + 1 + diff
            indexes.append(last)
        return cls(block_hash, indexes)


class BlockTransactions:
    """blocktxn payload."""

    def __init__(self, block_hash: bytes, txs: list[CTransaction]):
        self.block_hash = block_hash
        self.txs = txs

    def serialize(self) -> bytes:
        out = [self.block_hash, ser_compact_size(len(self.txs))]
        out.extend(tx.serialize() for tx in self.txs)
        return b"".join(out)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "BlockTransactions":
        block_hash = r.read_bytes(32)
        n = deser_compact_size(r)
        txs = [CTransaction.deserialize(r) for _ in range(n)]
        return cls(block_hash, txs)
