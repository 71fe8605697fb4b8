"""Base58Check — address / WIF codec.

Reference: src/base58.{h,cpp} (EncodeBase58Check, DecodeBase58Check,
CBitcoinAddress, CBitcoinSecret). Pure host-side; never hot.
"""

from __future__ import annotations

from typing import Optional

from .hashes import sha256d

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def b58encode(data: bytes) -> str:
    """EncodeBase58 (src/base58.cpp:~15)."""
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, rem = divmod(n, 58)
        out.append(_ALPHABET[rem])
    # leading zero bytes -> leading '1's
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def b58decode(s: str) -> Optional[bytes]:
    """DecodeBase58 — None on any non-alphabet char."""
    n = 0
    for c in s:
        v = _INDEX.get(c)
        if v is None:
            return None
        n = n * 58 + v
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in s:
        if c == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + body


def b58check_encode(payload: bytes) -> str:
    """EncodeBase58Check: payload + 4-byte sha256d checksum."""
    return b58encode(payload + sha256d(payload)[:4])


def b58check_decode(s: str) -> Optional[bytes]:
    """DecodeBase58Check — None on bad charset or checksum."""
    raw = b58decode(s)
    if raw is None or len(raw) < 4:
        return None
    payload, checksum = raw[:-4], raw[-4:]
    if sha256d(payload)[:4] != checksum:
        return None
    return payload
