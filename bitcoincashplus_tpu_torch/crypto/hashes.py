"""CPU hash primitives.

Reference: src/hash.h:~22 (CHash256 = double-SHA256), src/crypto/sha256.cpp
(CSHA256), src/crypto/ripemd160.cpp, src/crypto/hmac_sha512.cpp. Here the CPU
path delegates to OpenSSL via hashlib (the TPU path in ops/sha256.py is
the performance path; this is the correctness oracle and small-input path).

Also exposes the SHA-256 midstate utilities the mining kernel needs: the
80-byte header's first 64 bytes are constant across a nonce sweep, so the
compression state after block 0 ("midstate") is computed once per template
(SURVEY.md §4.5 kernel-critical structure).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct

# SHA-256 initial state (FIPS 180-4) — shared with ops/sha256.py.
SHA256_INIT = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SHA256_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_M32 = 0xFFFFFFFF


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def sha256d(b: bytes) -> bytes:
    """Double SHA-256 — CHash256 (src/hash.h:~22). Block/tx/checksum hash."""
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def ripemd160(b: bytes) -> bytes:
    return hashlib.new("ripemd160", b).digest()


def hash160(b: bytes) -> bytes:
    """RIPEMD160(SHA256(x)) — CHash160 (src/hash.h:~40). Addresses."""
    return ripemd160(sha256(b))


def hmac_sha512(key: bytes, msg: bytes) -> bytes:
    """BIP32 key derivation MAC (src/crypto/hmac_sha512.cpp)."""
    return _hmac.new(key, msg, hashlib.sha512).digest()


# ---- pure-Python SHA-256 compression (midstate support) ----

def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def sha256_compress(state: tuple, block: bytes) -> tuple:
    """One 64-byte compression round — CSHA256::Transform
    (src/crypto/sha256.cpp:~40). Pure Python: used only for midstates and as
    the oracle for the Pallas kernel; bulk hashing goes through hashlib or TPU.
    """
    assert len(block) == 64
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA256_K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return tuple((x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def header_midstate(header80: bytes) -> tuple:
    """SHA-256 state after compressing the first 64 of the 80 header bytes.

    Constant across a nonce sweep (nonce lives at bytes 76..79, in block 1) —
    the key PoW optimization (SURVEY.md §4.5).
    """
    assert len(header80) == 80
    return sha256_compress(SHA256_INIT, header80[:64])


def chunk2_round_state(midstate: tuple, tail12: bytes, rounds: int = 3) -> tuple:
    """Compression state after the first ``rounds`` rounds of the header's
    SECOND block (bytes 64..79 + padding), consuming only the
    nonce-independent words w0..w2 (merkle tail, nTime, nBits) — so
    ``rounds`` must be <= 3 (the nonce is w3).

    This is the CPU twin of the sweep kernel's per-template chunk-2 hoist
    (ops/sha256_sweep.hoist_template): the device precompute's early-round
    state is pinned bit-exactly against this oracle by the mining tests.
    """
    assert len(tail12) == 12 and 0 <= rounds <= 3
    w = struct.unpack(">3I", tail12)
    a, b, c, d, e, f, g, h = midstate
    for i in range(rounds):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA256_K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return (a, b, c, d, e, f, g, h)


def sha256d_from_midstate(midstate: tuple, tail16: bytes) -> bytes:
    """Finish SHA-256d of an 80-byte header given the block-0 midstate and the
    final 16 header bytes (merkle tail + time + bits + nonce)."""
    assert len(tail16) == 16
    # block 1: 16 bytes of message + 0x80 pad + zeros + 64-bit length (640 bits)
    block1 = tail16 + b"\x80" + b"\x00" * 39 + struct.pack(">Q", 80 * 8)
    h1 = sha256_compress(midstate, block1)
    digest1 = struct.pack(">8I", *h1)
    # second hash: 32-byte message, single padded block
    block2 = digest1 + b"\x80" + b"\x00" * 23 + struct.pack(">Q", 32 * 8)
    h2 = sha256_compress(SHA256_INIT, block2)
    return struct.pack(">8I", *h2)
