"""Signed messages — the "Bitcoin Signed Message" scheme.

Reference: src/util/message semantics live in rpcwallet.cpp/misc.cpp in the
v0.14 lineage (signmessage / verifymessage handlers) with the magic string
from CChainParams::strMessageMagic ("Bitcoin Signed Message:\n") and
CKey::SignCompact / CPubKey::RecoverCompact (src/key.cpp, src/pubkey.cpp).

Wire format: base64 of 65 bytes — header byte (27 + recid, +4 when the
signing key is compressed) then r and s as 32-byte big-endian scalars.
"""

from __future__ import annotations

import base64
from typing import Optional

from ..consensus.params import ChainParams
from ..consensus.serialize import ser_compact_size
from ..crypto import secp256k1 as secp
from ..crypto.hashes import hash160, sha256d
from .keys import CKey

MESSAGE_MAGIC = b"Bitcoin Signed Message:\n"


def message_hash(message: str) -> bytes:
    """CHashWriter << strMessageMagic << strMessage (both length-prefixed
    like string serialization), double-SHA256."""
    msg = message.encode("utf-8")
    data = (ser_compact_size(len(MESSAGE_MAGIC)) + MESSAGE_MAGIC
            + ser_compact_size(len(msg)) + msg)
    return sha256d(data)


def sign_message(key: CKey, message: str) -> str:
    """CKey::SignCompact over the message hash, base64-encoded."""
    e = int.from_bytes(message_hash(message), "big")
    r, s, recid = secp.ecdsa_sign_recoverable(key.secret, e)
    header = 27 + recid + (4 if key.compressed else 0)
    blob = bytes([header]) + r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return base64.b64encode(blob).decode("ascii")


def recover_pubkey(signature_b64: str, message: str) -> Optional[bytes]:
    """CPubKey::RecoverCompact — returns the serialized pubkey (in the
    compressed/uncompressed form the header byte claims), or None."""
    try:
        blob = base64.b64decode(signature_b64, validate=True)
    except Exception:
        return None
    if len(blob) != 65:
        return None
    header = blob[0]
    if not (27 <= header < 35):
        return None
    compressed = header >= 31
    recid = (header - 27) & 3
    r = int.from_bytes(blob[1:33], "big")
    s = int.from_bytes(blob[33:65], "big")
    e = int.from_bytes(message_hash(message), "big")
    pt = secp.ecdsa_recover(r, s, recid, e)
    if pt is None:
        return None
    return secp.pubkey_serialize(pt, compressed)


def verify_message(address: str, signature_b64: str, message: str,
                   params: ChainParams) -> bool:
    """verifymessage: recovered-key hash must equal the address's key hash
    (only P2PKH addresses identify a key)."""
    from ..crypto.base58 import b58check_decode

    payload = b58check_decode(address)
    if payload is None or len(payload) != 21:
        return False
    if payload[0] != params.pubkey_addr_prefix:
        return False
    pubkey = recover_pubkey(signature_b64, message)
    if pubkey is None:
        return False
    return hash160(pubkey) == payload[1:]
