"""Transaction primitives.

Reference: src/primitives/transaction.{h,cpp} (COutPoint, CTxIn, CTxOut,
CTransaction, CTransaction::ComputeHash). Wire format byte-identical; txid =
SHA256d(serialized tx). The BCH-lineage fork has no segwit, so there is a
single serialization (no wtxid distinction) [fork-delta, hedged — SURVEY.md §0].

Immutable-after-construction like the reference's CTransaction (which is
const); use TxBuilder-style mutation then freeze via CTransaction.from_parts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.hashes import sha256d
from .serialize import (
    ByteReader,
    deser_i32,
    deser_i64,
    deser_u32,
    deser_var_bytes,
    deser_vector,
    hash_to_hex,
    ser_i32,
    ser_i64,
    ser_u32,
    ser_var_bytes,
    ser_vector,
)

COIN = 100_000_000  # satoshis per coin (src/amount.h COIN)
MAX_MONEY = 21_000_000 * COIN  # src/amount.h (MAX_MONEY)

SEQUENCE_FINAL = 0xFFFFFFFF
# nSequence locktime flags (src/primitives/transaction.h ~CTxIn)
SEQUENCE_LOCKTIME_DISABLE_FLAG = 1 << 31
SEQUENCE_LOCKTIME_TYPE_FLAG = 1 << 22
SEQUENCE_LOCKTIME_MASK = 0x0000FFFF

LOCKTIME_THRESHOLD = 500_000_000  # below: block height, above: unix time


def money_range(v: int) -> bool:
    return 0 <= v <= MAX_MONEY


@dataclass(frozen=True)
class COutPoint:
    """(txid, vout index) — src/primitives/transaction.h (COutPoint)."""

    hash: bytes = b"\x00" * 32  # txid in wire order
    n: int = 0xFFFFFFFF

    def serialize(self) -> bytes:
        return self.hash + ser_u32(self.n)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "COutPoint":
        h = r.read_bytes(32)
        return cls(h, deser_u32(r))

    def is_null(self) -> bool:
        return self.hash == b"\x00" * 32 and self.n == 0xFFFFFFFF

    def __repr__(self) -> str:
        return f"COutPoint({bytes(reversed(self.hash)).hex()[:16]}…,{self.n})"


@dataclass(frozen=True)
class CTxIn:
    prevout: COutPoint = field(default_factory=COutPoint)
    script_sig: bytes = b""
    sequence: int = SEQUENCE_FINAL

    def serialize(self) -> bytes:
        return (
            self.prevout.serialize()
            + ser_var_bytes(self.script_sig)
            + ser_u32(self.sequence)
        )

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CTxIn":
        prevout = COutPoint.deserialize(r)
        script_sig = deser_var_bytes(r)
        return cls(prevout, script_sig, deser_u32(r))


@dataclass(frozen=True)
class CTxOut:
    value: int = -1  # satoshis
    script_pubkey: bytes = b""

    def serialize(self) -> bytes:
        return ser_i64(self.value) + ser_var_bytes(self.script_pubkey)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CTxOut":
        value = deser_i64(r)
        return cls(value, deser_var_bytes(r))

    def is_null(self) -> bool:
        return self.value == -1


class CTransaction:
    """Immutable transaction; hash computed once at construction
    (src/primitives/transaction.cpp CTransaction::ComputeHash)."""

    __slots__ = ("version", "vin", "vout", "locktime", "_ser", "_txid")

    CURRENT_VERSION = 2

    def __init__(
        self,
        version: int = CURRENT_VERSION,
        vin: tuple[CTxIn, ...] = (),
        vout: tuple[CTxOut, ...] = (),
        locktime: int = 0,
    ):
        self.version = version
        self.vin = tuple(vin)
        self.vout = tuple(vout)
        self.locktime = locktime
        self._ser = self._serialize()
        self._txid = sha256d(self._ser)

    def _serialize(self) -> bytes:
        return (
            ser_i32(self.version)
            + ser_vector(self.vin, CTxIn.serialize)
            + ser_vector(self.vout, CTxOut.serialize)
            + ser_u32(self.locktime)
        )

    def serialize(self) -> bytes:
        return self._ser

    @classmethod
    def deserialize(cls, r: ByteReader) -> "CTransaction":
        version = deser_i32(r)
        vin = deser_vector(r, CTxIn.deserialize)
        vout = deser_vector(r, CTxOut.deserialize)
        locktime = deser_u32(r)
        return cls(version, tuple(vin), tuple(vout), locktime)

    @classmethod
    def from_bytes(cls, b: bytes) -> "CTransaction":
        r = ByteReader(b)
        tx = cls.deserialize(r)
        if not r.empty():
            from .serialize import DeserializationError

            raise DeserializationError("trailing bytes after transaction")
        return tx

    @property
    def txid(self) -> bytes:
        """SHA256d of serialization, wire order."""
        return self._txid

    @property
    def txid_hex(self) -> str:
        return hash_to_hex(self._txid)

    def is_coinbase(self) -> bool:
        return len(self.vin) == 1 and self.vin[0].prevout.is_null()

    def total_output_value(self) -> int:
        return sum(o.value for o in self.vout)

    def size(self) -> int:
        return len(self._ser)

    def __eq__(self, other) -> bool:
        return isinstance(other, CTransaction) and self._txid == other._txid

    def __hash__(self) -> int:
        return int.from_bytes(self._txid[:8], "little")

    def __repr__(self) -> str:
        return f"CTransaction({self.txid_hex[:16]}…, {len(self.vin)} in, {len(self.vout)} out)"
