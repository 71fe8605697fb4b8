"""ZMQ block/tx notifications — a pure-Python ZMTP 3.0 PUB socket.

Reference: src/zmq/zmqpublishnotifier.cpp (CZMQAbstractPublishNotifier:
hashblock / hashtx / rawblock / rawtx topics over a PUB socket). The
environment has no libzmq/pyzmq, so this speaks the ZMTP 3.0 wire
protocol directly (greeting, NULL-mechanism READY handshake, framed
messages) — real ZMQ SUB clients (pyzmq, libzmq) can connect to it.

Publisher semantics match PUB: per-subscriber topic filters learned from
SUBSCRIBE (0x01) / CANCEL (0x00) messages, prefix matching, silent drop
for slow/dead subscribers. Each notification is a 3-part message
[topic, body, LE32 sequence] exactly like the reference.
"""

from __future__ import annotations

import asyncio
import struct
import threading
from typing import Optional

from ..util.log import log_print, log_printf

_SIGNATURE = b"\xff" + b"\x00" * 8 + b"\x7f"


def _greeting(as_server: bool = False) -> bytes:
    # 64-byte ZMTP 3.0 greeting: signature, version, mechanism, as-server
    return (_SIGNATURE + bytes([3, 0])
            + b"NULL" + b"\x00" * 16
            + (b"\x01" if as_server else b"\x00")
            + b"\x00" * 31)


def _command(name: bytes, body: bytes) -> bytes:
    payload = bytes([len(name)]) + name + body
    if len(payload) <= 255:
        return bytes([0x04, len(payload)]) + payload
    return b"\x06" + struct.pack(">Q", len(payload)) + payload


def _frame(body: bytes, more: bool) -> bytes:
    flags = 0x01 if more else 0x00
    if len(body) <= 255:
        return bytes([flags, len(body)]) + body
    return bytes([flags | 0x02]) + struct.pack(">Q", len(body)) + body


class _Subscriber:
    def __init__(self, writer):
        self.writer = writer
        self.topics: set[bytes] = set()

    def wants(self, topic: bytes) -> bool:
        return any(topic.startswith(t) for t in self.topics)


class ZMQPublisher:
    """One PUB endpoint serving all enabled topics (the reference binds one
    socket per -zmqpub* arg; a shared socket is protocol-equivalent for
    subscribers, which filter by topic)."""

    # per-subscriber high-water mark: past this buffered-byte count new
    # messages are dropped for that subscriber (ZMQ_SNDHWM role)
    SNDHWM_BYTES = 4 * 1024 * 1024

    def __init__(self, node, port: int, topics: set[str],
                 host: str = "127.0.0.1"):
        self.node = node
        self.host = host
        self.port = port
        self.topics = {t.encode() for t in topics}
        self.sequences = {t.encode(): 0 for t in topics}
        self._subs: list[_Subscriber] = []
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="zmq",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(15):
            raise RuntimeError("ZMQ publisher failed to start")
        if self._start_error is not None:
            raise RuntimeError(
                f"ZMQ publisher bind failed on {self.host}:{self.port}: "
                f"{self._start_error}") from self._start_error
        log_printf("ZMQ publisher on tcp://%s:%d topics=%s",
                   self.host, self.port,
                   ",".join(sorted(t.decode() for t in self.topics)))

    def _run(self) -> None:
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)

        async def _serve():
            self._server = await asyncio.start_server(
                self._on_subscriber, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

        try:
            self.loop.run_until_complete(_serve())
        except BaseException as e:  # surfaced by start() with the cause
            self._start_error = e
            self._started.set()
            self.loop.close()
            return
        self._started.set()
        self.loop.run_forever()
        self.loop.close()

    def close(self) -> None:
        if self.loop is None:
            return

        def _shutdown():
            for sub in self._subs:
                try:
                    sub.writer.close()
                except Exception:
                    pass
            if self._server is not None:
                self._server.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(10)
        self.loop = None  # publish() after close becomes a no-op

    # -- subscriber handling -------------------------------------------

    async def _on_subscriber(self, reader, writer) -> None:
        sub = _Subscriber(writer)
        try:
            writer.write(_greeting(as_server=True))
            peer_greeting = await reader.readexactly(64)
            # RFC 23: only the signature's first and last byte are fixed —
            # libzmq fills the padding with a ZMTP/1.0 compat length field,
            # so checking the zero bytes would reject real clients
            if peer_greeting[0] != 0xFF or peer_greeting[9] != 0x7F:
                writer.close()
                return
            writer.write(_command(b"READY", b"\x0bSocket-Type\x00\x00\x00\x03PUB"))
            await writer.drain()
            self._subs.append(sub)
            while True:
                flags = (await reader.readexactly(1))[0]
                if flags & 0x02:  # long frame
                    (size,) = struct.unpack(">Q", await reader.readexactly(8))
                else:
                    size = (await reader.readexactly(1))[0]
                body = await reader.readexactly(size) if size else b""
                if flags & 0x04:
                    continue  # commands (READY etc.) — nothing to do
                if body[:1] == b"\x01":
                    sub.topics.add(body[1:])
                elif body[:1] == b"\x00":
                    sub.topics.discard(body[1:])
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            if sub in self._subs:
                self._subs.remove(sub)
            try:
                writer.close()
            except Exception:
                pass

    # -- publishing -----------------------------------------------------

    def publish(self, topic: str, body: bytes) -> None:
        """Send [topic, body, seq] to interested subscribers (thread-safe;
        callable from validation/RPC threads)."""
        t = topic.encode()
        loop = self.loop  # snapshot: close() clears it concurrently
        if t not in self.topics or loop is None:
            return
        seq = self.sequences[t]
        self.sequences[t] = (seq + 1) & 0xFFFFFFFF
        wire = (_frame(t, more=True) + _frame(body, more=True)
                + _frame(struct.pack("<I", seq), more=False))

        def _do():
            for sub in list(self._subs):
                if not sub.wants(t):
                    continue
                try:
                    transport = sub.writer.transport
                    # ZMQ_SNDHWM analogue: a stalled-but-alive subscriber
                    # gets messages DROPPED, not buffered without bound
                    if (transport is not None and
                            transport.get_write_buffer_size()
                            > self.SNDHWM_BYTES):
                        continue
                    sub.writer.write(wire)
                except Exception:
                    pass  # PUB drops to dead subscribers silently
        try:
            loop.call_soon_threadsafe(_do)
        except RuntimeError:
            pass  # loop closed by a concurrent shutdown


# -- test/client helper: a minimal ZMTP SUB client ----------------------


class ZMQSubscriber:
    """Blocking SUB client for tests and tooling (what a pyzmq SUB socket
    would do): connect, subscribe to topics, recv_multipart()."""

    def __init__(self, port: int, topics: list[bytes], timeout: float = 30.0):
        import socket as _socket

        self.sock = _socket.create_connection(("127.0.0.1", port),
                                              timeout=timeout)
        self.sock.sendall(_greeting(as_server=False))
        self._recv_exact(64)  # their greeting
        self.sock.sendall(_command(b"READY", b"\x0bSocket-Type\x00\x00\x00\x03SUB"))
        self._read_frame()  # their READY
        for t in topics:
            self.sock.sendall(_frame(b"\x01" + t, more=False))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("publisher closed")
            buf += chunk
        return buf

    def _read_frame(self) -> tuple[int, bytes]:
        flags = self._recv_exact(1)[0]
        if flags & 0x02:
            (size,) = struct.unpack(">Q", self._recv_exact(8))
        else:
            size = self._recv_exact(1)[0]
        return flags, (self._recv_exact(size) if size else b"")

    def recv_multipart(self) -> list[bytes]:
        parts = []
        while True:
            flags, body = self._read_frame()
            if flags & 0x04:
                continue  # skip commands
            parts.append(body)
            if not flags & 0x01:
                return parts

    def close(self) -> None:
        self.sock.close()
