"""BIP37 bloom filters — SPV client filtering.

Reference: src/bloom.{h,cpp} (CBloomFilter, MurmurHash3,
IsRelevantAndUpdate), src/hash.cpp:~10 (MurmurHash3). The filter is pure
host-side peer state (tiny, branchy, per-peer) — nothing here belongs on
the chip.
"""

from __future__ import annotations

import math
import struct

from ..consensus.serialize import (
    ByteReader,
    deser_compact_size,
    ser_compact_size,
)
from ..consensus.tx import COutPoint, CTransaction

MAX_BLOOM_FILTER_SIZE = 36_000  # bytes
MAX_HASH_FUNCS = 50

# nFlags (bloom.h)
BLOOM_UPDATE_NONE = 0
BLOOM_UPDATE_ALL = 1
BLOOM_UPDATE_P2PUBKEY_ONLY = 2
BLOOM_UPDATE_MASK = 3

LN2_SQUARED = math.log(2) ** 2
LN2 = math.log(2)


def murmur3(seed: int, data: bytes) -> int:
    """MurmurHash3 x86_32 (src/hash.cpp MurmurHash3) — exact."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & 0xFFFFFFFF
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        (k1,) = struct.unpack_from("<I", data, i * 4)
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
        h1 = (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF
    k1 = 0
    tail = data[n_blocks * 4:]
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    return h1


class CBloomFilter:
    """src/bloom.cpp CBloomFilter. Construct either from (n_elements,
    fp_rate, tweak, flags) or from wire data via `from_wire`."""

    def __init__(self, n_elements: int = 1, fp_rate: float = 0.0001,
                 tweak: int = 0, flags: int = BLOOM_UPDATE_NONE):
        size = int(-1 / LN2_SQUARED * n_elements * math.log(fp_rate) / 8)
        size = max(1, min(size, MAX_BLOOM_FILTER_SIZE))
        self.data = bytearray(size)
        n_hash = int(len(self.data) * 8 / n_elements * LN2)
        self.n_hash_funcs = max(1, min(n_hash, MAX_HASH_FUNCS))
        self.tweak = tweak
        self.flags = flags

    @classmethod
    def from_wire(cls, data: bytes, n_hash_funcs: int, tweak: int,
                  flags: int) -> "CBloomFilter":
        self = cls.__new__(cls)
        self.data = bytearray(data)
        self.n_hash_funcs = n_hash_funcs
        self.tweak = tweak
        self.flags = flags
        return self

    def is_within_size_constraints(self) -> bool:
        return (len(self.data) <= MAX_BLOOM_FILTER_SIZE
                and self.n_hash_funcs <= MAX_HASH_FUNCS)

    def _hash(self, n: int, data: bytes) -> int:
        seed = (n * 0xFBA4C795 + self.tweak) & 0xFFFFFFFF
        return murmur3(seed, data) % (len(self.data) * 8)

    def insert(self, data: bytes) -> None:
        if not self.data:
            return
        for i in range(self.n_hash_funcs):
            bit = self._hash(i, data)
            self.data[bit >> 3] |= 1 << (bit & 7)

    def insert_outpoint(self, outpoint: COutPoint) -> None:
        self.insert(outpoint.hash + struct.pack("<I", outpoint.n))

    def contains(self, data: bytes) -> bool:
        if not self.data:
            return True  # a full/degenerate filter matches everything
        for i in range(self.n_hash_funcs):
            bit = self._hash(i, data)
            if not self.data[bit >> 3] & (1 << (bit & 7)):
                return False
        return True

    def contains_outpoint(self, outpoint: COutPoint) -> bool:
        return self.contains(outpoint.hash + struct.pack("<I", outpoint.n))

    def is_relevant_and_update(self, tx: CTransaction) -> bool:
        """CBloomFilter::IsRelevantAndUpdate: does this tx interest the
        filter's owner? Matching outputs are (per nFlags) inserted as
        outpoints so follow-on spends match too."""
        from ..script.script import classify_script, get_script_ops

        found = False
        if not self.data:
            return True
        if self.contains(tx.txid):
            found = True
        for i, out in enumerate(tx.vout):
            matched = False
            try:
                for _op, push, _ in get_script_ops(out.script_pubkey):
                    if push and self.contains(bytes(push)):
                        matched = True
                        break
            except Exception:
                pass  # unparseable script: no data elements to match
            if matched:
                found = True
                update = self.flags & BLOOM_UPDATE_MASK
                if update == BLOOM_UPDATE_ALL:
                    self.insert_outpoint(COutPoint(tx.txid, i))
                elif update == BLOOM_UPDATE_P2PUBKEY_ONLY:
                    if classify_script(out.script_pubkey) in ("pubkey",
                                                              "multisig"):
                        self.insert_outpoint(COutPoint(tx.txid, i))
        if found:
            return True
        for txin in tx.vin:
            if self.contains_outpoint(txin.prevout):
                return True
            try:
                for _op, push, _ in get_script_ops(txin.script_sig):
                    if push and self.contains(bytes(push)):
                        return True
            except Exception:
                pass
        return False


# ---- wire codecs (filterload / filteradd) -----------------------------


def ser_filterload(f: CBloomFilter) -> bytes:
    return (ser_compact_size(len(f.data)) + bytes(f.data)
            + struct.pack("<IIB", f.n_hash_funcs, f.tweak, f.flags))


def deser_filterload(payload: bytes) -> CBloomFilter:
    r = ByteReader(payload)
    n = deser_compact_size(r)
    data = r.read_bytes(n)
    n_hash, tweak, flags = struct.unpack("<IIB", r.read_bytes(9))
    return CBloomFilter.from_wire(data, n_hash, tweak, flags)
