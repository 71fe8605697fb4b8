"""Block primitives.

Reference: src/primitives/block.{h,cpp} (CBlockHeader, CBlock,
CBlockHeader::GetHash at src/primitives/block.cpp:~13). The 80-byte header
layout is the kernel-critical structure for the TPU nonce sweep:

    bytes  0..3   nVersion        (i32 LE)
    bytes  4..35  hashPrevBlock   (32B wire order)
    bytes 36..67  hashMerkleRoot  (32B wire order)
    bytes 68..71  nTime           (u32 LE)
    bytes 72..75  nBits           (u32 LE)
    bytes 76..79  nNonce          (u32 LE)   <- inside SHA-256 message block 1

Bytes 0..63 are constant across a nonce sweep → midstate precompute
(SURVEY.md §4.5; crypto/hashes.py header_midstate).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..crypto.hashes import sha256d
from .serialize import (
    ByteReader,
    DeserializationError,
    deser_i32,
    deser_u32,
    deser_vector,
    hash_to_hex,
    ser_i32,
    ser_u32,
    ser_vector,
)
from .tx import CTransaction

HEADER_SIZE = 80
NONCE_OFFSET = 76


@dataclass(frozen=True)
class CBlockHeader:
    version: int = 0
    hash_prev_block: bytes = b"\x00" * 32
    hash_merkle_root: bytes = b"\x00" * 32
    time: int = 0
    bits: int = 0
    nonce: int = 0

    def serialize(self) -> bytes:
        return (
            ser_i32(self.version)
            + self.hash_prev_block
            + self.hash_merkle_root
            + ser_u32(self.time)
            + ser_u32(self.bits)
            + ser_u32(self.nonce)
        )

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CBlockHeader":
        return cls(
            version=deser_i32(r),
            hash_prev_block=r.read_bytes(32),
            hash_merkle_root=r.read_bytes(32),
            time=deser_u32(r),
            bits=deser_u32(r),
            nonce=deser_u32(r),
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "CBlockHeader":
        if len(b) != HEADER_SIZE:
            raise DeserializationError("header must be 80 bytes")
        return cls.deserialize(ByteReader(b))

    def get_hash(self) -> bytes:
        """SHA256d of the 80-byte serialization — CBlockHeader::GetHash."""
        return sha256d(self.serialize())

    @property
    def hash_hex(self) -> str:
        return hash_to_hex(self.get_hash())

    def with_nonce(self, nonce: int) -> "CBlockHeader":
        return replace(self, nonce=nonce)


@dataclass(frozen=True)
class CBlock:
    header: CBlockHeader
    vtx: tuple[CTransaction, ...] = ()

    def serialize(self) -> bytes:
        return self.header.serialize() + ser_vector(self.vtx, CTransaction.serialize)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CBlock":
        header = CBlockHeader.deserialize(r)
        vtx = deser_vector(r, CTransaction.deserialize)
        return cls(header, tuple(vtx))

    @classmethod
    def from_bytes(cls, b: bytes) -> "CBlock":
        r = ByteReader(b)
        blk = cls.deserialize(r)
        if not r.empty():
            raise DeserializationError("trailing bytes after block")
        return blk

    def get_hash(self) -> bytes:
        return self.header.get_hash()

    @property
    def hash_hex(self) -> str:
        return self.header.hash_hex

    def size(self) -> int:
        return len(self.serialize())
