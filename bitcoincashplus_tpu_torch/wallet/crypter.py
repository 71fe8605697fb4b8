"""Wallet encryption — src/wallet/crypter.{h,cpp} (CCrypter, CMasterKey,
CCryptoKeyStore semantics).

Scheme (exactly the reference's):
  - A random 32-byte *master key* encrypts every private key.
  - The master key itself is stored encrypted under a key derived from the
    user passphrase: SHA-512(passphrase || salt) iterated `rounds` times
    (BytesToKeySHA512AES — key = digest[0:32], iv = digest[32:48]).
  - Each secret is AES-256-CBC encrypted under (master key, iv) where
    iv = sha256d(pubkey)[0:16] — binding ciphertext to its key pair.
  - Unlock = decrypt master key with the passphrase-derived key and check a
    known pubkey round-trips; wrong passphrase -> padding/verify failure.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

from ..crypto.aes import aes256_cbc_decrypt, aes256_cbc_encrypt
from ..crypto.hashes import sha256d

DEFAULT_ROUNDS = 25_000  # the reference calibrates to ~100ms; fixed here


def bytes_to_key_sha512(passphrase: bytes, salt: bytes,
                        rounds: int) -> tuple[bytes, bytes]:
    """BytesToKeySHA512AES: iterated SHA-512 KDF -> (32-byte key, 16-byte iv)."""
    assert rounds >= 1
    d = hashlib.sha512(passphrase + salt).digest()
    for _ in range(rounds - 1):
        d = hashlib.sha512(d).digest()
    return d[:32], d[32:48]


@dataclass
class MasterKey:
    """CMasterKey: the encrypted master key record (wallet.dat mkey)."""

    encrypted_key: bytes
    salt: bytes
    rounds: int = DEFAULT_ROUNDS

    def to_dict(self) -> dict:
        return {"encrypted_key": self.encrypted_key.hex(),
                "salt": self.salt.hex(), "rounds": self.rounds}

    @classmethod
    def from_dict(cls, d: dict) -> "MasterKey":
        return cls(bytes.fromhex(d["encrypted_key"]),
                   bytes.fromhex(d["salt"]), d["rounds"])


def new_master_key(passphrase: str,
                   rounds: int = DEFAULT_ROUNDS) -> tuple[MasterKey, bytes]:
    """EncryptKeys setup: generate a random master key, seal it under the
    passphrase. Returns (record, plaintext master key)."""
    master = os.urandom(32)
    salt = os.urandom(8)
    key, iv = bytes_to_key_sha512(passphrase.encode(), salt, rounds)
    return MasterKey(aes256_cbc_encrypt(key, iv, master), salt, rounds), master


def unseal_master_key(mk: MasterKey, passphrase: str) -> bytes | None:
    """Decrypt the master key; None on wrong passphrase (bad padding)."""
    key, iv = bytes_to_key_sha512(passphrase.encode(), mk.salt, mk.rounds)
    try:
        out = aes256_cbc_decrypt(key, iv, mk.encrypted_key)
    except ValueError:
        return None
    return out if len(out) == 32 else None


def secret_iv(pubkey: bytes) -> bytes:
    """Per-key iv: sha256d(pubkey)[0:16] (EncryptSecret's chIV)."""
    return sha256d(pubkey)[:16]


def encrypt_secret(master: bytes, secret32: bytes, pubkey: bytes) -> bytes:
    assert len(secret32) == 32
    return aes256_cbc_encrypt(master, secret_iv(pubkey), secret32)


def decrypt_secret(master: bytes, ciphertext: bytes,
                   pubkey: bytes) -> bytes | None:
    try:
        out = aes256_cbc_decrypt(master, secret_iv(pubkey), ciphertext)
    except ValueError:
        return None
    return out if len(out) == 32 else None
