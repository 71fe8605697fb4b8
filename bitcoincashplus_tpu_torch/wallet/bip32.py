"""BIP32 hierarchical deterministic keys.

Reference: src/key.cpp (CExtKey::Derive), src/pubkey.cpp (CExtPubKey::
Derive), src/bip32.h path helpers; the reference wallet derives keypool
keys at m/0'/0'/i' (src/wallet/wallet.cpp CWallet::DeriveNewChildKey,
0.13+ HD wallets). Vectors: the BIP's published TV1/TV2 (test_bip32.py).
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from typing import Optional

from ..crypto import secp256k1 as secp
from ..crypto.base58 import b58check_decode, b58check_encode
from ..crypto.hashes import hash160

HARDENED = 0x80000000

# mainnet version bytes (testnet's tprv/tpub differ; the extended-key
# encoding is an interchange format, so we keep mainnet like the dumps)
XPRV_VERSION = bytes.fromhex("0488ADE4")
XPUB_VERSION = bytes.fromhex("0488B21E")


class ExtKey:
    """CExtKey / CExtPubKey in one: private when `secret` is set."""

    __slots__ = ("depth", "parent_fingerprint", "child_number", "chain_code",
                 "secret", "point")

    def __init__(self, depth: int, parent_fingerprint: bytes,
                 child_number: int, chain_code: bytes,
                 secret: Optional[int] = None, point=None):
        self.depth = depth
        self.parent_fingerprint = parent_fingerprint
        self.child_number = child_number
        self.chain_code = chain_code
        self.secret = secret
        self.point = point if point is not None else (
            secp.point_mul(secret, secp.G) if secret else None
        )

    # -- construction ----------------------------------------------------

    @classmethod
    def from_seed(cls, seed: bytes) -> "ExtKey":
        """CExtKey::SetMaster — HMAC-SHA512("Bitcoin seed", seed)."""
        digest = hmac.new(b"Bitcoin seed", seed, hashlib.sha512).digest()
        secret = int.from_bytes(digest[:32], "big")
        if not (1 <= secret < secp.N):
            raise ValueError("invalid seed (master key out of range)")
        return cls(0, b"\x00" * 4, 0, digest[32:], secret=secret)

    @property
    def is_private(self) -> bool:
        return self.secret is not None

    def pubkey_bytes(self) -> bytes:
        return secp.pubkey_serialize(self.point, compressed=True)

    def fingerprint(self) -> bytes:
        return hash160(self.pubkey_bytes())[:4]

    def neuter(self) -> "ExtKey":
        """CExtKey::Neuter — the corresponding extended public key."""
        return ExtKey(self.depth, self.parent_fingerprint, self.child_number,
                      self.chain_code, secret=None, point=self.point)

    # -- derivation ------------------------------------------------------

    def derive(self, i: int) -> "ExtKey":
        """CKDpriv / CKDpub (CExtKey::Derive, CExtPubKey::Derive)."""
        hardened = bool(i & HARDENED)
        if hardened:
            if not self.is_private:
                raise ValueError("hardened derivation from a public key")
            data = b"\x00" + self.secret.to_bytes(32, "big")
        else:
            data = self.pubkey_bytes()
        digest = hmac.new(self.chain_code,
                          data + struct.pack(">I", i), hashlib.sha512).digest()
        tweak = int.from_bytes(digest[:32], "big")
        if tweak >= secp.N:
            raise ValueError("derivation tweak out of range (try next index)")
        if self.is_private:
            child_secret = (self.secret + tweak) % secp.N
            if child_secret == 0:
                raise ValueError("zero child key (try next index)")
            return ExtKey(self.depth + 1, self.fingerprint(), i,
                          digest[32:], secret=child_secret)
        child_point = secp.point_add(secp.point_mul(tweak, secp.G), self.point)
        if child_point is None:
            raise ValueError("infinity child key (try next index)")
        return ExtKey(self.depth + 1, self.fingerprint(), i,
                      digest[32:], secret=None, point=child_point)

    def derive_path(self, path: str) -> "ExtKey":
        """'m/0'/0'/5'' or 'm/44/0/1h' style paths."""
        node = self
        parts = path.split("/")
        if parts and parts[0] in ("m", "M", ""):
            parts = parts[1:]
        for part in parts:
            if not part:
                continue
            hardened = part[-1] in ("'", "h", "H")
            idx = int(part[:-1] if hardened else part)
            node = node.derive(idx | (HARDENED if hardened else 0))
        return node

    # -- serialization (base58check xprv/xpub) ---------------------------

    def serialize(self) -> str:
        if self.is_private:
            version = XPRV_VERSION
            keydata = b"\x00" + self.secret.to_bytes(32, "big")
        else:
            version = XPUB_VERSION
            keydata = self.pubkey_bytes()
        payload = (version + bytes([self.depth]) + self.parent_fingerprint
                   + struct.pack(">I", self.child_number)
                   + self.chain_code + keydata)
        return b58check_encode(payload)

    @classmethod
    def parse(cls, encoded: str) -> Optional["ExtKey"]:
        payload = b58check_decode(encoded)
        if payload is None or len(payload) != 78:
            return None
        version, rest = payload[:4], payload[4:]
        depth = rest[0]
        fingerprint = rest[1:5]
        (child_number,) = struct.unpack(">I", rest[5:9])
        chain_code = rest[9:41]
        keydata = rest[41:74]
        if version == XPRV_VERSION:
            if keydata[0] != 0:
                return None
            secret = int.from_bytes(keydata[1:], "big")
            if not (1 <= secret < secp.N):
                return None
            return cls(depth, fingerprint, child_number, chain_code,
                       secret=secret)
        if version == XPUB_VERSION:
            point = secp.pubkey_parse(keydata)
            if point is None:
                return None
            return cls(depth, fingerprint, child_number, chain_code,
                       secret=None, point=point)
        return None
