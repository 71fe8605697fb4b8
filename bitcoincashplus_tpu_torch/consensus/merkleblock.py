"""Partial merkle trees + filtered blocks.

Reference: src/merkleblock.{h,cpp} (CPartialMerkleTree, CMerkleBlock).
A partial merkle tree proves a subset of a block's txids against its
merkle root with ~32·log(n) bytes: a depth-first traversal emitting one
flag bit per visited node and a hash for every pruned subtree (and every
matched leaf). Serves `merkleblock` P2P responses to BIP37 peers and the
gettxoutproof/verifytxoutproof RPCs.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..crypto.hashes import sha256d
from .serialize import (
    ByteReader,
    deser_compact_size,
    ser_compact_size,
)

# cap nTransactions like the reference: a block can't carry more txs than
# size/60 (minimal tx size); used to reject absurd proofs before allocating
MAX_BLOCK_SIZE = 8_000_000
MIN_TX_SIZE = 60


class CPartialMerkleTree:
    def __init__(self, n_transactions: int = 0,
                 bits: Optional[list[bool]] = None,
                 hashes: Optional[list[bytes]] = None):
        self.n_transactions = n_transactions
        self.bits: list[bool] = bits or []
        self.hashes: list[bytes] = hashes or []
        self.bad = False

    # -- construction (CPartialMerkleTree::CPartialMerkleTree) ----------

    @classmethod
    def from_txids(cls, txids: list[bytes],
                   matches: list[bool]) -> "CPartialMerkleTree":
        self = cls(len(txids))
        height = 0
        while self._calc_tree_width(height) > 1:
            height += 1
        self._traverse_and_build(height, 0, txids, matches)
        return self

    def _calc_tree_width(self, height: int) -> int:
        return (self.n_transactions + (1 << height) - 1) >> height

    def _calc_hash(self, height: int, pos: int, txids: list[bytes]) -> bytes:
        if height == 0:
            return txids[pos]
        left = self._calc_hash(height - 1, pos * 2, txids)
        if pos * 2 + 1 < self._calc_tree_width(height - 1):
            right = self._calc_hash(height - 1, pos * 2 + 1, txids)
        else:
            right = left
        return sha256d(left + right)

    def _traverse_and_build(self, height: int, pos: int,
                            txids: list[bytes], matches: list[bool]) -> None:
        parent_of_match = False
        p = pos << height
        while p < (pos + 1) << height and p < self.n_transactions:
            parent_of_match |= matches[p]
            p += 1
        self.bits.append(parent_of_match)
        if height == 0 or not parent_of_match:
            self.hashes.append(self._calc_hash(height, pos, txids))
        else:
            self._traverse_and_build(height - 1, pos * 2, txids, matches)
            if pos * 2 + 1 < self._calc_tree_width(height - 1):
                self._traverse_and_build(height - 1, pos * 2 + 1, txids,
                                         matches)

    # -- verification (ExtractMatches) -----------------------------------

    def _traverse_and_extract(self, height: int, pos: int, cursor: list[int],
                              matched: list[tuple[int, bytes]]) -> bytes:
        bits_used, hashes_used = cursor
        if bits_used >= len(self.bits):
            self.bad = True
            return b"\x00" * 32
        parent_of_match = self.bits[bits_used]
        cursor[0] += 1
        if height == 0 or not parent_of_match:
            if cursor[1] >= len(self.hashes):
                self.bad = True
                return b"\x00" * 32
            h = self.hashes[cursor[1]]
            cursor[1] += 1
            if height == 0 and parent_of_match:
                matched.append((pos, h))
            return h
        left = self._traverse_and_extract(height - 1, pos * 2, cursor, matched)
        if pos * 2 + 1 < self._calc_tree_width(height - 1):
            right = self._traverse_and_extract(height - 1, pos * 2 + 1,
                                               cursor, matched)
            if right == left:
                # identical left/right is the CVE-2012-2459 mutation shape
                self.bad = True
        else:
            right = left
        return sha256d(left + right)

    def extract_matches(self) -> Optional[tuple[bytes, list[tuple[int, bytes]]]]:
        """Returns (merkle_root, [(position, txid), ...]) or None if the
        proof is malformed (all the reference's rejection conditions)."""
        self.bad = False
        if self.n_transactions == 0:
            return None
        if self.n_transactions > MAX_BLOCK_SIZE // MIN_TX_SIZE:
            return None
        if len(self.hashes) > self.n_transactions:
            return None
        if len(self.bits) < len(self.hashes):
            return None
        height = 0
        while self._calc_tree_width(height) > 1:
            height += 1
        cursor = [0, 0]
        matched: list[tuple[int, bytes]] = []
        root = self._traverse_and_extract(height, 0, cursor, matched)
        if self.bad:
            return None
        # every bit and hash must be consumed (no trailing garbage)
        if (cursor[0] + 7) // 8 != (len(self.bits) + 7) // 8:
            return None
        if cursor[1] != len(self.hashes):
            return None
        return root, matched

    # -- serialization ---------------------------------------------------

    def serialize(self) -> bytes:
        out = [struct.pack("<I", self.n_transactions),
               ser_compact_size(len(self.hashes))]
        out.extend(self.hashes)
        packed = bytearray((len(self.bits) + 7) // 8)
        for i, bit in enumerate(self.bits):
            if bit:
                packed[i >> 3] |= 1 << (i & 7)
        out.append(ser_compact_size(len(packed)))
        out.append(bytes(packed))
        return b"".join(out)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CPartialMerkleTree":
        (n_tx,) = struct.unpack("<I", r.read_bytes(4))
        n_hashes = deser_compact_size(r)
        hashes = [r.read_bytes(32) for _ in range(n_hashes)]
        n_bytes = deser_compact_size(r)
        packed = r.read_bytes(n_bytes)
        bits = [bool(packed[i >> 3] & (1 << (i & 7)))
                for i in range(n_bytes * 8)]
        return cls(n_tx, bits, hashes)


class CMerkleBlock:
    """src/merkleblock.h CMerkleBlock: header + partial tree over the
    subset of txs selected by a bloom filter or explicit txid set."""

    def __init__(self, header, pmt: CPartialMerkleTree,
                 matched_txids: Optional[list[bytes]] = None):
        self.header = header
        self.pmt = pmt
        # convenience for the P2P path: which full txs to send after the
        # merkleblock message
        self.matched_txids = matched_txids or []

    @classmethod
    def from_block(cls, block, bloom_filter=None,
                   txid_set: Optional[set[bytes]] = None) -> "CMerkleBlock":
        txids = [tx.txid for tx in block.vtx]
        if bloom_filter is not None:
            matches = [bloom_filter.is_relevant_and_update(tx)
                       for tx in block.vtx]
        else:
            txid_set = txid_set or set()
            matches = [txid in txid_set for txid in txids]
        pmt = CPartialMerkleTree.from_txids(txids, matches)
        matched = [t for t, m in zip(txids, matches) if m]
        return cls(block.header, pmt, matched)

    def serialize(self) -> bytes:
        return self.header.serialize() + self.pmt.serialize()

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CMerkleBlock":
        from .block import CBlockHeader

        header = CBlockHeader.deserialize(r)
        pmt = CPartialMerkleTree.deserialize(r)
        return cls(header, pmt)

    @classmethod
    def from_bytes(cls, b: bytes) -> "CMerkleBlock":
        return cls.deserialize(ByteReader(b))
