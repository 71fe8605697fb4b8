"""Wire protocol: message framing + payload codecs.

Reference: src/protocol.h (CMessageHeader: 4B netmagic, 12B NUL-padded
command, u32 payload length, 4B SHA256d checksum; CInv: u32 type + 32B
hash), src/version.h (PROTOCOL_VERSION), message payload layouts from
src/net_processing.cpp / primitives serialization.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from ..consensus.serialize import (
    ByteReader,
    deser_compact_size,
    ser_compact_size,
)
from ..crypto.hashes import sha256d

PROTOCOL_VERSION = 70015
NODE_NETWORK = 1
MAX_PAYLOAD_SIZE = 32 * 1024 * 1024  # MAX_PROTOCOL_MESSAGE_LENGTH ballpark
MAX_HEADERS_RESULTS = 2000  # MAX_HEADERS_RESULTS (net_processing.cpp)
MAX_LOCATOR_SZ = 101

# CInv types (src/protocol.h)
MSG_TX = 1
MSG_BLOCK = 2
MSG_FILTERED_BLOCK = 3  # BIP37: getdata answered with merkleblock
MSG_CMPCT_BLOCK = 4     # BIP152: getdata answered with cmpctblock

HEADER_SIZE = 24


class NetMessageError(Exception):
    """Malformed wire data. Raising this always ends the connection; the
    ``score`` is what gets recorded on the sender's ban-score ledger for
    the event (connman.CConnman.misbehaving). The default of 100 matches
    the ledger's default threshold, so an un-annotated raise records an
    immediate discharge — the historical behavior. score=0 marks a benign
    protocol disconnect (self-connect, duplicate version): the connection
    still ends but nothing reaches the ledger or the attack counters. A
    raise with a lower positive score would disconnect WITHOUT recording
    a discharge; truly graduated (accumulating) offenses must instead
    charge via misbehaving() and return, since a per-connection ledger
    resets on reconnect."""

    def __init__(self, message: str, score: int = 100):
        super().__init__(message)
        self.score = score


@dataclass
class MessageHeader:
    magic: bytes
    command: str
    length: int
    checksum: bytes

    @classmethod
    def parse(cls, raw: bytes, expect_magic: bytes) -> "MessageHeader":
        if len(raw) != HEADER_SIZE:
            raise NetMessageError("short header")
        magic = raw[:4]
        if magic != expect_magic:
            raise NetMessageError(f"bad netmagic {magic.hex()}")
        cmd_raw = raw[4:16]
        cmd = cmd_raw.rstrip(b"\x00")
        if b"\x00" in cmd or not cmd.isascii():
            raise NetMessageError("non-canonical command field")
        (length,) = struct.unpack_from("<I", raw, 16)
        if length > MAX_PAYLOAD_SIZE:
            raise NetMessageError(f"oversized payload {length}")
        return cls(magic, cmd.decode("ascii"), length, raw[20:24])


def pack_message(magic: bytes, command: str, payload: bytes = b"") -> bytes:
    cmd = command.encode("ascii")
    if len(cmd) > 12:
        raise ValueError(f"command too long: {command}")
    return (
        magic + cmd.ljust(12, b"\x00")
        + struct.pack("<I", len(payload))
        + sha256d(payload)[:4]
        + payload
    )


def check_payload(header: MessageHeader, payload: bytes) -> None:
    if sha256d(payload)[:4] != header.checksum:
        raise NetMessageError(f"bad checksum for {header.command}")


# ---- payload codecs ---------------------------------------------------


def _ser_netaddr(services: int = NODE_NETWORK, port: int = 0) -> bytes:
    """CAddress sans time (as used inside `version`): loopback v4-mapped."""
    ip = b"\x00" * 10 + b"\xff\xff" + bytes([127, 0, 0, 1])
    return struct.pack("<Q", services) + ip + struct.pack(">H", port)


@dataclass
class VersionPayload:
    version: int = PROTOCOL_VERSION
    services: int = NODE_NETWORK
    timestamp: int = field(default_factory=lambda: int(time.time()))
    nonce: int = 0
    user_agent: str = "/bcpd-tpu:0.4.0/"
    start_height: int = 0
    relay: bool = True

    def serialize(self) -> bytes:
        ua = self.user_agent.encode()
        return (
            struct.pack("<iQq", self.version, self.services, self.timestamp)
            + _ser_netaddr(self.services)
            + _ser_netaddr(self.services)
            + struct.pack("<Q", self.nonce)
            + ser_compact_size(len(ua)) + ua
            + struct.pack("<i", self.start_height)
            + (b"\x01" if self.relay else b"\x00")
        )

    @classmethod
    def parse(cls, payload: bytes) -> "VersionPayload":
        try:
            r = ByteReader(payload)
            version, services, timestamp = struct.unpack("<iQq", r.read_bytes(20))
            r.read_bytes(26 * 2)  # addr_recv, addr_from
            (nonce,) = struct.unpack("<Q", r.read_bytes(8))
            ua_len = deser_compact_size(r)
            ua = r.read_bytes(ua_len).decode(errors="replace")
            (start_height,) = struct.unpack("<i", r.read_bytes(4))
            relay = bool(r.read_bytes(1)[0]) if not r.empty() else True
        except Exception as e:
            raise NetMessageError(f"bad version payload: {e}") from None
        return cls(version, services, timestamp, nonce, ua, start_height, relay)


def ser_inv(items: list[tuple[int, bytes]]) -> bytes:
    out = [ser_compact_size(len(items))]
    for inv_type, h in items:
        out.append(struct.pack("<I", inv_type) + h)
    return b"".join(out)


def deser_inv(payload: bytes) -> list[tuple[int, bytes]]:
    try:
        r = ByteReader(payload)
        n = deser_compact_size(r)
        if n > 50_000:  # MAX_INV_SZ
            raise NetMessageError("oversized inv")
        items = []
        for _ in range(n):
            (inv_type,) = struct.unpack("<I", r.read_bytes(4))
            items.append((inv_type, r.read_bytes(32)))
        return items
    except NetMessageError:
        raise
    except Exception as e:
        raise NetMessageError(f"bad inv: {e}") from None


def ser_getheaders(locator: list[bytes], hash_stop: bytes = b"\x00" * 32) -> bytes:
    out = [struct.pack("<I", PROTOCOL_VERSION), ser_compact_size(len(locator))]
    out.extend(locator)
    out.append(hash_stop)
    return b"".join(out)


def deser_getheaders(payload: bytes) -> tuple[list[bytes], bytes]:
    try:
        r = ByteReader(payload)
        r.read_bytes(4)  # client version, unused
        n = deser_compact_size(r)
        if n > MAX_LOCATOR_SZ:
            raise NetMessageError("oversized locator")
        locator = [r.read_bytes(32) for _ in range(n)]
        return locator, r.read_bytes(32)
    except NetMessageError:
        raise
    except Exception as e:
        raise NetMessageError(f"bad getheaders: {e}") from None


def ser_headers(headers: list) -> bytes:
    """headers message: each entry is an 80B header + 00 tx count."""
    out = [ser_compact_size(len(headers))]
    for h in headers:
        out.append(h.serialize() + b"\x00")
    return b"".join(out)


def deser_headers(payload: bytes) -> list:
    from ..consensus.block import CBlockHeader

    try:
        r = ByteReader(payload)
        n = deser_compact_size(r)
        if n > MAX_HEADERS_RESULTS:
            raise NetMessageError("too many headers")
        headers = []
        for _ in range(n):
            headers.append(CBlockHeader.deserialize(r))
            deser_compact_size(r)  # tx count, always 0
        return headers
    except NetMessageError:
        raise
    except Exception as e:
        raise NetMessageError(f"bad headers: {e}") from None


def ser_ping(nonce: int) -> bytes:
    return struct.pack("<Q", nonce)


def deser_ping(payload: bytes) -> int:
    if len(payload) != 8:
        raise NetMessageError("bad ping")
    return struct.unpack("<Q", payload)[0]


# ---- addr message (CAddress with time, src/protocol.h) ---------------


def ser_addr_entries(entries: list[tuple[int, int, str, int]]) -> bytes:
    """addr payload: [(time, services, ipv4_host, port), ...]."""
    out = [ser_compact_size(len(entries))]
    for t, services, host, port in entries:
        try:
            ip4 = bytes(int(x) for x in host.split("."))
            if len(ip4) != 4:
                raise ValueError(host)
        except Exception:
            ip4 = bytes([127, 0, 0, 1])
        out.append(struct.pack("<IQ", t & 0xFFFFFFFF, services)
                   + b"\x00" * 10 + b"\xff\xff" + ip4
                   + struct.pack(">H", port))
    return b"".join(out)


def deser_addr_entries(payload: bytes) -> list[tuple[int, int, str, int]]:
    try:
        r = ByteReader(payload)
        n = deser_compact_size(r)
        if n > 1000:  # MAX_ADDR_TO_SEND
            raise NetMessageError("oversized addr")
        out = []
        for _ in range(n):
            t, services = struct.unpack("<IQ", r.read_bytes(12))
            ip = r.read_bytes(16)
            (port,) = struct.unpack(">H", r.read_bytes(2))
            if ip[:12] == b"\x00" * 10 + b"\xff\xff":  # v4-mapped
                host = ".".join(str(b) for b in ip[12:])
            else:
                host = "::"  # v6 unsupported in this deployment
            out.append((t, services, host, port))
        return out
    except NetMessageError:
        raise
    except Exception as e:
        raise NetMessageError(f"bad addr: {e}") from None
