"""SipHash-2-4 — the BIP152 short-transaction-ID hash.

Reference: src/crypto/siphash.cpp (CSipHasher, SipHashUint256Extra). Pure
host-side (tiny keyed hash over 32-byte txids); nothing to accelerate.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def siphash24(k0: int, k1: int, data: bytes) -> int:
    """Standard SipHash-2-4 of ``data`` under key (k0, k1) → u64."""
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & _MASK
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & _MASK
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & _MASK
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & _MASK
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    n_blocks = len(data) // 8
    for i in range(n_blocks):
        (m,) = struct.unpack_from("<Q", data, i * 8)
        v3 ^= m
        rounds(2)
        v0 ^= m
    # final block: remaining bytes + length in the top byte
    tail = data[n_blocks * 8:]
    b = (len(data) & 0xFF) << 56
    for i, byte in enumerate(tail):
        b |= byte << (8 * i)
    v3 ^= b
    rounds(2)
    v0 ^= b
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK
