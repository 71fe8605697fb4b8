"""Bitcoin wire serialization primitives.

Re-designs the reference's template-based stream serialization
(src/serialize.h READWRITE macros, src/streams.h CDataStream) as explicit
little-endian codec functions over ``bytes`` / ``memoryview``. The wire format
is consensus-critical and byte-identical to the reference; only the idiom
changes (no C++ template metaprogramming — plain functions + a cursor).
"""

from __future__ import annotations

import struct

MAX_SIZE = 0x02000000  # src/serialize.h:~26 (MAX_SIZE) — sanity bound for sizes


class DeserializationError(ValueError):
    """Raised on malformed wire bytes (reference: std::ios_base::failure)."""


class ByteReader:
    """Cursor over immutable bytes — replaces CDataStream's read side.
    __slots__ + a cached length: this type's read methods are the hottest
    Python frames in a -reindex (hundreds of calls per transaction), so
    every attribute lookup and len() matters."""

    __slots__ = ("data", "pos", "_len")

    def __init__(self, data: bytes | bytearray | memoryview, pos: int = 0):
        self.data = memoryview(data)
        self.pos = pos
        self._len = len(self.data)

    def read(self, n: int) -> memoryview:
        pos = self.pos
        if n < 0 or pos + n > self._len:
            raise DeserializationError(
                f"read past end: want {n} at {pos}, have {self._len}"
            )
        self.pos = pos + n
        return self.data[pos:pos + n]

    def read_bytes(self, n: int) -> bytes:
        pos = self.pos
        if n < 0 or pos + n > self._len:
            raise DeserializationError(
                f"read past end: want {n} at {pos}, have {self._len}"
            )
        self.pos = pos + n
        return bytes(self.data[pos:pos + n])

    @property
    def remaining(self) -> int:
        return self._len - self.pos

    def empty(self) -> bool:
        return self.pos >= self._len


# ---- fixed-width little-endian integers ----

def ser_u8(v: int) -> bytes:
    return struct.pack("<B", v)


def ser_u16(v: int) -> bytes:
    return struct.pack("<H", v)


def ser_u32(v: int) -> bytes:
    return struct.pack("<I", v)


def ser_i32(v: int) -> bytes:
    return struct.pack("<i", v)


def ser_u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def ser_i64(v: int) -> bytes:
    return struct.pack("<q", v)


# precompiled Structs + unpack_from straight off the memoryview: no slice
# objects, no per-call format parse (reindex-hot)
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")


def deser_u8(r: ByteReader) -> int:
    return r.read(1)[0]


def _deser_fixed(r: ByteReader, st, n: int) -> int:
    pos = r.pos
    if pos + n > r._len:
        raise DeserializationError(
            f"read past end: want {n} at {pos}, have {r._len}"
        )
    r.pos = pos + n
    return st.unpack_from(r.data, pos)[0]


def deser_u16(r: ByteReader) -> int:
    return _deser_fixed(r, _U16, 2)


def deser_u32(r: ByteReader) -> int:
    return _deser_fixed(r, _U32, 4)


def deser_i32(r: ByteReader) -> int:
    return _deser_fixed(r, _I32, 4)


def deser_u64(r: ByteReader) -> int:
    return _deser_fixed(r, _U64, 8)


def deser_i64(r: ByteReader) -> int:
    return _deser_fixed(r, _I64, 8)


# ---- CompactSize varint (src/serialize.h:~200 WriteCompactSize/ReadCompactSize) ----

def ser_compact_size(n: int) -> bytes:
    if n < 0:
        raise ValueError("negative compact size")
    if n < 253:
        return struct.pack("<B", n)
    if n <= 0xFFFF:
        return b"\xfd" + struct.pack("<H", n)
    if n <= 0xFFFFFFFF:
        return b"\xfe" + struct.pack("<I", n)
    return b"\xff" + struct.pack("<Q", n)


def deser_compact_size(r: ByteReader, range_check: bool = True) -> int:
    tag = r.read(1)[0]
    if tag < 253:
        n = tag
    elif tag == 253:
        n = deser_u16(r)
        if n < 253:
            raise DeserializationError("non-canonical CompactSize")
    elif tag == 254:
        n = deser_u32(r)
        if n < 0x10000:
            raise DeserializationError("non-canonical CompactSize")
    else:
        n = deser_u64(r)
        if n < 0x100000000:
            raise DeserializationError("non-canonical CompactSize")
    if range_check and n > MAX_SIZE:
        raise DeserializationError("CompactSize exceeds MAX_SIZE")
    return n


# ---- variable-length byte strings / vectors ----

def ser_var_bytes(b: bytes) -> bytes:
    return ser_compact_size(len(b)) + b


def deser_var_bytes(r: ByteReader) -> bytes:
    n = deser_compact_size(r)
    return r.read_bytes(n)


def ser_vector(items, ser_item) -> bytes:
    out = [ser_compact_size(len(items))]
    for it in items:
        out.append(ser_item(it))
    return b"".join(out)


def deser_vector(r: ByteReader, deser_item) -> list:
    n = deser_compact_size(r)
    # Do not pre-allocate by claimed n (DoS); items bound the loop naturally.
    return [deser_item(r) for _ in range(n)]


# ---- uint256 <-> bytes helpers (src/uint256.h) ----
# Internal convention: a hash is 32 raw bytes in *wire order* (little-endian of
# the number). Hex display is byte-reversed, matching uint256::GetHex.

def uint256_from_bytes(b: bytes) -> int:
    if len(b) != 32:
        raise ValueError("uint256 needs 32 bytes")
    return int.from_bytes(b, "little")


def uint256_to_bytes(v: int) -> bytes:
    return v.to_bytes(32, "little")


def hash_to_hex(b: bytes) -> str:
    """32 wire bytes -> display hex (reversed), e.g. block hashes in RPC."""
    return bytes(reversed(b)).hex()


def hex_to_hash(s: str) -> bytes:
    """Display hex -> 32 wire bytes."""
    b = bytes.fromhex(s)
    if len(b) != 32:
        raise ValueError("hash hex must be 64 chars")
    return bytes(reversed(b))
