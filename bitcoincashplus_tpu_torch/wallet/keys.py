"""Keys and addresses.

Reference: src/key.{h,cpp} (CKey), src/pubkey.h (CPubKey),
src/base58.cpp (CBitcoinAddress, CBitcoinSecret / WIF).
"""

from __future__ import annotations

import os
from typing import Optional

from ..consensus.params import ChainParams
from ..crypto import secp256k1 as secp
from ..crypto.base58 import b58check_decode, b58check_encode
from ..crypto.hashes import hash160
from ..script.script import is_p2sh, p2pkh_script, p2sh_script


class CKey:
    """A private key + derived pubkey (src/key.h CKey)."""

    __slots__ = ("secret", "compressed", "pubkey")

    def __init__(self, secret: int, compressed: bool = True):
        if not (1 <= secret < secp.N):
            raise ValueError("secret out of range")
        self.secret = secret
        self.compressed = compressed
        self.pubkey = secp.privkey_to_pubkey(secret, compressed)

    @classmethod
    def generate(cls, compressed: bool = True) -> "CKey":
        """MakeNewKey — rejection-sample 32 random bytes (src/key.cpp)."""
        while True:
            candidate = int.from_bytes(os.urandom(32), "big")
            if 1 <= candidate < secp.N:
                return cls(candidate, compressed)

    @classmethod
    def from_wif(cls, wif: str, params: ChainParams) -> Optional["CKey"]:
        """CBitcoinSecret::SetString."""
        payload = b58check_decode(wif)
        if not payload or payload[0] != params.secret_key_prefix:
            return None
        body = payload[1:]
        if len(body) == 33 and body[-1] == 0x01:
            return cls(int.from_bytes(body[:32], "big"), compressed=True)
        if len(body) == 32:
            return cls(int.from_bytes(body, "big"), compressed=False)
        return None

    def to_wif(self, params: ChainParams) -> str:
        """CBitcoinSecret::ToString."""
        body = self.secret.to_bytes(32, "big")
        if self.compressed:
            body += b"\x01"
        return b58check_encode(bytes([params.secret_key_prefix]) + body)

    @property
    def pubkey_hash(self) -> bytes:
        return hash160(self.pubkey)

    def p2pkh_address(self, params: ChainParams) -> str:
        return b58check_encode(
            bytes([params.pubkey_addr_prefix]) + self.pubkey_hash
        )

    def p2pkh_script(self) -> bytes:
        return p2pkh_script(self.pubkey_hash)

    def sign(self, msg_hash32: bytes) -> bytes:
        """DER-encoded signature WITHOUT hashtype byte (CKey::Sign)."""
        e = int.from_bytes(msg_hash32, "big")
        from .. import native

        if native.available():
            # bit-identical to the oracle signer (same RFC6979 nonce),
            # ~100x faster — differential-tested in test_native.py
            r, s = native.ecdsa_sign(self.secret, e)
        else:
            r, s = secp.ecdsa_sign(self.secret, e)
        return secp.sig_der_encode(r, s)


def address_to_script(addr: str, params: ChainParams) -> Optional[bytes]:
    """CBitcoinAddress → scriptPubKey (DecodeDestination + GetScriptForDestination)."""
    payload = b58check_decode(addr)
    if payload is None or len(payload) != 21:
        return None
    version, h = payload[0], payload[1:]
    if version == params.pubkey_addr_prefix:
        return p2pkh_script(h)
    if version == params.script_addr_prefix:
        return p2sh_script(h)
    return None


def script_to_address(script_pubkey: bytes, params: ChainParams) -> Optional[str]:
    """scriptPubKey → address (ExtractDestination + EncodeDestination)."""
    if (
        len(script_pubkey) == 25
        and script_pubkey[:3] == bytes([0x76, 0xA9, 20])
        and script_pubkey[23:] == bytes([0x88, 0xAC])
    ):
        return b58check_encode(
            bytes([params.pubkey_addr_prefix]) + script_pubkey[3:23]
        )
    if is_p2sh(script_pubkey):
        return b58check_encode(
            bytes([params.script_addr_prefix]) + script_pubkey[2:22]
        )
    return None
