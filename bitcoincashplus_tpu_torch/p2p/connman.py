"""Connection manager + message processing.

Reference: src/net.cpp (CConnman: accept loop, peer lifecycle — the
reference's ThreadSocketHandler/ThreadMessageHandler pair is one asyncio
event loop on a dedicated thread here), src/net_processing.cpp
(ProcessMessage: the per-command logic below follows its shape, minimal
subset; headers-first sync as in the reference's getheaders/headers/
getdata flow). Chainstate/mempool access happens under node.cs_main.

Fault handling (net_processing.cpp DoS machinery): every protocol reject
site charges the sending peer's ban-score ledger via misbehaving(score,
reason) — framing errors and invalid blocks discharge immediately (score
100 >= threshold), while recoverable offenses (non-connecting headers,
invalid txs, receive-rate floods, withheld blocks) accumulate until the
configurable threshold evicts the peer. Per-peer in-flight block tracking
with stall detection re-requests withheld blocks from another peer
(BLOCK_DOWNLOAD_TIMEOUT), the orphan pool is byte-budgeted with
seeded-random eviction and per-peer attribution, and the banlist persists
across restarts (banlist.json, banman.cpp DumpBanlist/LoadBanlist).
"""

from __future__ import annotations

import asyncio
import os
import random
import secrets
import struct
import threading
import time
from typing import Optional

from ..consensus.block import CBlock
from ..consensus.serialize import hash_to_hex
from ..consensus.tx import CTransaction
from ..consensus.pow import check_headers_pow_batch
from ..mempool.mempool import MempoolError
from ..store.kvstore import atomic_write_json, read_json
from ..util import lockwatch
from ..util import telemetry as tm
from ..util.faults import INJECTOR, Backoff, InjectedFault, NET_SITE
from ..util.log import log_print, log_printf
from ..validation.chain import BlockStatus
from ..validation.chainstate import BlockValidationError
from .bloom import (
    MAX_BLOOM_FILTER_SIZE,
    CBloomFilter,
    deser_filterload,
)
from .protocol import (
    HEADER_SIZE,
    MAX_HEADERS_RESULTS,
    MSG_BLOCK,
    MSG_CMPCT_BLOCK,
    MSG_FILTERED_BLOCK,
    MSG_TX,
    MessageHeader,
    NetMessageError,
    VersionPayload,
    check_payload,
    deser_getheaders,
    deser_headers,
    deser_inv,
    deser_ping,
    pack_message,
    ser_getheaders,
    ser_headers,
    ser_inv,
    ser_ping,
)


MAX_ORPHAN_TX = 100  # DEFAULT_MAX_ORPHAN_TRANSACTIONS
MAX_ORPHAN_BYTES = 500_000   # byte budget for the whole orphan pool
MAX_ORPHAN_TX_SIZE = 100_000  # larger orphans are dropped outright
ORPHAN_EXPIRE_TIME = 1200    # ORPHAN_TX_EXPIRE_TIME (20 min)
PING_INTERVAL = 120       # net.cpp PING_INTERVAL
TIMEOUT_INTERVAL = 1200   # net.cpp TIMEOUT_INTERVAL (20 min)
RELAY_TX_CACHE_TIME = 900  # mapRelay retention (15 min, net_processing.cpp)

# Misbehavior charges (net_processing.cpp Misbehaving call sites). A
# NetMessageError's own ``score`` covers the raise-sites; these cover the
# graduated, non-fatal ones. Values are fractions of the default 100
# threshold — see README "Adversarial peers & DoS limits".
CHARGE_NONCONNECTING_HEADERS = 10  # unsolicited headers on unknown parent
CHARGE_INVALID_TX = 10             # consensus-invalid tx (not policy/fee)
CHARGE_RECV_FLOOD = 25             # one tick over the receive-rate ceiling
# "bad-txns-*" reject reasons that are POLICY or subjective to our own
# chain state, never misbehavior — an honest relayer hits all of these in
# normal operation (mempool/accept.py raises them only on the mempool
# path; the block-connect versions of in-belowout etc. stay consensus)
POLICY_BAD_TXNS = frozenset({
    "bad-txns-nonstandard-inputs",           # input standardness (policy)
    "bad-txns-too-many-sigops",              # MAX_STANDARD_TX_SIGOPS cap
    "bad-txns-premature-spend-of-coinbase",  # subjective to our height
})
# Default rate limit on the non-connecting-headers charge
# (MAX_UNCONNECTING_HEADERS): an honest peer hits the offense in bursts
# (tip announcements racing a reorg, announcements during our own IBD), so
# only every Nth occurrence since the peer last taught us a NEW connecting
# header is charged — a garbage-replayer still accumulates to the
# threshold, an honest peer's counter keeps getting reset and never does
# (replaying already-known headers is not redemption). Tunable via
# -maxunconnectingheaders (tests pin 1 to drive the graduated path fast).
MAX_UNCONNECTING_HEADERS = 10

# BIP61 reject codes (src/consensus/validation.h REJECT_*)
REJECT_MALFORMED = 0x01
REJECT_INVALID = 0x10
REJECT_DUPLICATE = 0x12
REJECT_NONSTANDARD = 0x40
REJECT_INSUFFICIENTFEE = 0x42

class Peer:
    """CNode — one connected peer."""

    _next_id = 0

    def __init__(self, connman: "CConnman", reader, writer, outbound: bool):
        Peer._next_id += 1
        self.id = Peer._next_id
        self.connman = connman
        self.reader = reader
        self.writer = writer
        self.outbound = outbound
        peername = writer.get_extra_info("peername") or ("?", 0)
        self.addr = f"{peername[0]}:{peername[1]}"
        self.version: Optional[VersionPayload] = None
        self.got_verack = False
        self.prefers_headers = False  # BIP130 sendheaders
        # BIP37 SPV state: None = no filter (relay per relay_txs);
        # set by filterload, updated by matches per nFlags
        self.bloom_filter: Optional[CBloomFilter] = None
        # fRelayTxes: seeded from the version message's relay byte;
        # filterload/filterclear force it back on (BIP37 semantics)
        self.relay_txs = True
        # BIP152: peer sent sendcmpct(announce=1) → announce new tips as
        # cmpctblock (high-bandwidth mode)
        self.cmpct_announce = False
        # one in-flight compact-block reconstruction (PartiallyDownloadedBlock)
        self.pending_cmpct = None
        # BIP133 feefilter: don't announce txs below this rate (sat/kB)
        self.min_fee_filter = 0
        self.known_invs: set[bytes] = set()
        self.connected_at = time.time()
        self.last_recv = 0.0
        self.last_send = 0.0
        self.bytes_recv = 0
        self.bytes_sent = 0
        # -- ban-score ledger (net_processing.cpp CNodeState::nMisbehavior)
        self.ban_score = 0
        self.charges: dict[str, int] = {}  # reason -> accumulated score
        self.discharged = False            # threshold crossed, eviction due
        # -- block-download state (CNodeState vBlocksInFlight)
        self.inflight: set[bytes] = set()  # block hashes getdata'd, unseen
        self.last_block_progress = 0.0     # last getdata sent / block recvd
        self.stalling = False
        self.stalling_since = 0.0
        self.stall_charge = 0  # provisional charge, rolled back on redeem
        # non-connecting headers messages since the last connecting one
        # (CNodeState::nUnconnectingHeaders)
        self.unconnecting_headers = 0
        # -- receive-rate accounting (per-tick window)
        self.recv_window = 0   # bytes received in the current tick window
        self.recv_rate = 0.0   # bytes/sec over the last completed window
        self.flood_strikes = 0
        self.last_ping_sent = self.connected_at

    @property
    def handshaked(self) -> bool:
        return self.version is not None and self.got_verack

    def send(self, command: str, payload: bytes = b"") -> None:
        raw = pack_message(self.connman.magic, command, payload)
        self.writer.write(raw)
        self.bytes_sent += len(raw)
        self.connman.bytes_sent += len(raw)
        self.last_send = time.time()

    def info(self) -> dict:
        """getpeerinfo row (src/rpc/net.cpp)."""
        return {
            "id": self.id,
            "addr": self.addr,
            "inbound": not self.outbound,
            "version": self.version.version if self.version else 0,
            "subver": self.version.user_agent if self.version else "",
            "startingheight": self.version.start_height if self.version else -1,
            "conntime": int(self.connected_at),
            "bytessent": self.bytes_sent,
            "bytesrecv": self.bytes_recv,
            # ban-score ledger + download/rate state (this framework's
            # DoS observability; the reference exposes banscore too)
            "banscore": self.ban_score,
            "charges": dict(self.charges),
            "inflight": len(self.inflight),
            "stalling": self.stalling,
            "recvrate": round(self.recv_rate, 1),
            "floodstrikes": self.flood_strikes,
        }


# telemetry: supervision-tick duration — a tick that blocks the event
# loop shows up here long before peers start timing out
_TICK_H = tm.histogram(
    "bcp_net_tick_seconds",
    "P2P supervision tick (_tick) duration",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 0.5, 1.0))


class CConnman:
    # machine-enforced by bcplint BCP009: every static write site (and
    # every caller-holds path the reachability analysis can see) must
    # hold the named lock. _ban_seq is bumped in _snapshot_banlist with
    # ban_lock held by the caller — the interprocedural lockset proves
    # it, so the convention is checked, not just documented.
    GUARDED_BY = {
        "_banned": "ban_lock",
        "_ban_seq": "ban_lock",
        "_ban_saved_seq": "ban_io_lock",
    }

    def __init__(self, node, bind_host: str = "127.0.0.1", listen_port: int = 0):
        self.node = node
        self.magic = node.params.netmagic
        self.bind_host = bind_host
        self.listen_port = listen_port  # 0 = don't listen
        self.port = 0
        self.peers: dict[int, Peer] = {}
        self.bytes_recv = 0
        self.bytes_sent = 0
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        # in-flight block downloads: hash -> requesting peer id. Entries are
        # dropped on block arrival; a stalled or disconnected peer's
        # entries are re-requested from another peer (or dropped when none
        # remain) — otherwise one wedged peer would leave the hash
        # "requested" forever and sync would deadlock.
        self._requested_blocks: dict[bytes, int] = {}
        # blocks we know we need but currently have no peer to ask (their
        # owner stalled/disconnected and every other announcer is busy);
        # _tick re-requests them as soon as an announcer is available
        self._unrequested: set[bytes] = set()
        # hash -> ids of peers whose announcement (headers batch or
        # cmpctblock) included it. Re-requests are routed ONLY to
        # announcers: a peer can only be held accountable (stall charges,
        # eviction) for blocks it claimed to have — handing an attacker's
        # undeliverable hashes to an arbitrary honest peer would let the
        # stall detector cascade-evict peers that never had them. Entries
        # are created only for accepted headers (PoW-gated) and dropped
        # on delivery or when the last announcer disconnects.
        self._block_sources: dict[bytes, set[int]] = {}
        self._nonce = secrets.randbits(64)  # self-connect detection
        # -- tunables for the supervision machinery. Reads go through
        # node.net_limits when the node built one (node/node.py), with the
        # same defaults otherwise so bare test stubs work.
        limits = getattr(node, "net_limits", None) or {}
        # DISCOURAGEMENT_THRESHOLD: ban_score at/above this evicts
        self.ban_threshold = int(limits.get("banscore", 100))
        # BLOCK_DOWNLOAD_TIMEOUT analogue (seconds without download
        # progress before a peer with blocks in flight counts as stalling)
        self.block_download_timeout = float(
            limits.get("blockdownloadtimeout", 60))
        # supervision tick cadence (_tick) — pings, stall checks, expiry
        self.tick_interval = float(limits.get("nettick", 5))
        # per-peer receive ceiling, bytes/sec averaged over one tick
        # window; 0 disables
        self.max_recv_rate = int(limits.get("maxrecvrate", 4_000_000))
        # charge every Nth non-connecting headers message (see
        # MAX_UNCONNECTING_HEADERS above)
        self.max_unconnecting = max(1, int(
            limits.get("maxunconnectingheaders", MAX_UNCONNECTING_HEADERS)))
        # when the last supervision tick actually ran (None before the
        # first): the receive-rate window divides by REAL elapsed time so
        # a delayed tick doesn't inflate honest peers' measured rates
        self._last_tick: Optional[float] = None
        # seed for the orphan-eviction rng: deterministic when set (tests/
        # chaos campaigns), OS entropy when -1 (production default — a
        # predictable eviction order is itself an attack surface)
        seed = int(limits.get("netseed", -1))
        self._rng = random.Random(seed if seed >= 0 else None)
        # aggregate supervision counters (gettpuinfo "net" section)
        self.net_stats = {
            "misbehavior_charges": 0,   # individual charges applied
            "discharged_peers": 0,      # peers evicted at the threshold
            "stall_rerequests": 0,      # blocks re-requested off a STALLER
            "disconnect_rerequests": 0,  # moved off an ordinary disconnect
            "parked_handoffs": 0,       # parked blocks handed out by _tick
            "evicted_stallers": 0,
            "flood_charges": 0,         # recv-rate ceiling violations
            "orphans_evicted": 0,       # random evictions at the budget
            "net_faults_injected": 0,   # BCP_FAULT_OPS=net drops
            "backfill_retries": 0,      # backfill deadlines that fired
            "backfill_peer_evictions": 0,  # peers struck from backfill
        }
        # assumeutxo backfill supervision: the shadow-validation thread's
        # history pull must never wedge behind one dead/stalling peer for
        # a full blockdownloadtimeout — every backfill hash carries its
        # own (shorter) deadline; on expiry the hash is torn off its
        # owner and re-requested from the NEXT peer after a jittered
        # Backoff pause, and a peer that repeatedly eats backfill
        # requests is struck out of the backfill rotation (it still
        # serves normal announcements — the strike-out is scoped to the
        # pull the peer demonstrably can't serve).
        self.backfill_timeout = float(limits.get(
            "backfilltimeout", min(10.0, self.block_download_timeout)))
        # hash -> {"peer": owner id, "deadline": abs time, "boff":
        #          per-hash Backoff, "retry_at": pause gate (0 = none)}
        self._backfill: dict[bytes, dict] = {}
        self._backfill_strikes: dict[int, int] = {}
        self._backfill_evicted: set[int] = set()
        self.discharge_reasons: dict[str, int] = {}  # reason -> evictions
        # CConnman/BanMan (src/banman.cpp): ip -> ban-expiry unix time.
        # Host granularity (no CIDR) matching how we track peers. Persisted
        # across restarts via banlist.json (banman.cpp LoadBanlist).
        self._banlist_path = os.path.join(node.datadir, "banlist.json")
        # _ban_lock guards the in-memory dict only (is_banned runs on the
        # event loop for every accept/dial — it must never wait on disk);
        # mutators snapshot under it and persist OUTSIDE it, serialized
        # by _ban_io_lock with a sequence check so an older snapshot can
        # never overwrite a newer one (atomic_write_bytes renames a fixed
        # path + ".tmp", so concurrent writers must not interleave)
        self._ban_lock = lockwatch.watched_lock("ban_lock")
        self._ban_io_lock = lockwatch.watched_lock("ban_io_lock")
        # publish the static GUARDED_BY vocabulary to the runtime
        # sentinel so gettpuinfo.lockwatch and docs/CONCURRENCY.md agree
        for field, lk in self.GUARDED_BY.items():
            lockwatch.declare_guards(lk, [field])
        self._ban_seq = 0        # bumped under _ban_lock per mutation
        self._ban_saved_seq = 0  # last seq persisted (under _ban_io_lock)
        self._banned: dict[str, float] = self._load_banlist()
        # telemetry: tick-duration histogram (inline in _tick) plus a
        # scrape-time collector projecting net_stats and per-peer recv
        # rates into the registry — live state, no stale labeled gauges
        # for long-gone peers. Re-registering replaces any previous
        # connman's collector (one live P2P stack per process).
        tm.register_collector("net", self._telemetry_families)
        self.bantime = 86400  # -bantime default
        # mapOrphanTransactions (net_processing.cpp): txs whose inputs we
        # don't know yet. Bounded by count AND bytes; over-budget inserts
        # evict a seeded-random victim (LimitOrphanTxSize), and a peer's
        # orphans are erased when it disconnects (per-peer attribution).
        # txid -> (tx, source peer id, serialized size, parked-at time)
        self._orphans: dict[bytes, tuple[CTransaction, int, int, float]] = {}
        self._orphan_bytes = 0
        # -addnode / addnode RPC "add" targets (vAddedNodes, net.cpp)
        self.added_nodes: list[str] = []
        # mapRelay (net_processing.cpp): recently relayed txs kept
        # RELAY_TX_CACHE_TIME so getdata can be served after the tx leaves
        # the mempool (e.g. it was just mined)
        self._relay_memory: dict[bytes, tuple[CTransaction, float]] = {}
        # CAddrMan + peers.dat (src/addrman.cpp, net.cpp DumpAddresses)
        from .addrman import AddrMan

        self.addrman = AddrMan()
        self._peers_path = os.path.join(node.datadir, "peers.json")
        n_loaded = self.addrman.load(self._peers_path)
        if n_loaded:
            log_print("net", "loaded %d addresses from peers.json", n_loaded)
        # -maxconnections (net.cpp nMaxConnections, default 125): inbound
        # accepts are refused at the cap
        self.max_connections = node.config.get_int("maxconnections", 125)
        # ThreadOpenConnections target, clamped by the total cap exactly
        # like the reference's min(MAX_OUTBOUND_CONNECTIONS, nMaxConnections)
        self.max_outbound = min(8, self.max_connections)
        # reconnect pacing (util/faults.Backoff): repeated dial failures
        # back the open-connections loop off exponentially with jitter
        # (instead of the old fixed 5 s poll hammering a dead candidate
        # list); any completed handshake resets it to the base interval
        self._dial_backoff = Backoff(base=5.0, factor=2.0, maximum=60.0,
                                     jitter=0.5)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="p2p", daemon=True)
        self._thread.start()
        if not self._started.wait(30):
            raise RuntimeError("P2P event loop failed to start")
        self.node.chainstate.on_tip_changed.append(self._on_tip_changed)

    def _run(self) -> None:
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        if self.listen_port:  # 0 = -listen=0 (outbound only)
            self.loop.run_until_complete(self._start_server())
        self.loop.create_task(self._tick_loop())
        self.loop.create_task(self._open_connections_loop())
        self._started.set()
        self.loop.run_forever()
        # drain: close transports
        for task in asyncio.all_tasks(self.loop):
            task.cancel()
        self.loop.run_until_complete(asyncio.sleep(0))
        self.loop.close()

    async def _tick_loop(self) -> None:
        """Drive _tick on a fixed cadence. The cadence (self.tick_interval)
        bounds how fast stalls, floods, and inactivity are noticed — it is
        deliberately much shorter than PING_INTERVAL; _tick itself paces
        pings by wall clock."""
        while True:
            await asyncio.sleep(self.tick_interval)
            try:
                self._tick(time.time())
            except Exception as e:  # the supervisor itself must not die
                log_printf("P2P tick error: %r", e)

    def _tick(self, now: float) -> None:
        """One supervision pass (InactivityCheck + PingPeriodicity of
        net.cpp:~1300 plus this framework's stall/flood/expiry sweeps).
        Takes the clock as an argument so tests drive it directly with a
        fake ``now`` — no sleeping, no event loop required.

        Per tick: expire mapRelay and aged orphans; then per peer — drop
        on inactivity, ping on cadence, close the receive-rate window
        (charging floods), and run block-download stall detection
        (re-request from another peer, then evict the staller)."""
        t_tick = time.monotonic()
        # speculation-tree stale sweep: a tip held inside the -spechold
        # grace (or a fork-race tie) must still externalize when no
        # further block ever arrives — re-run the live settle policy
        # each tick so getbestblockhash/listeners lag a quiet tip by at
        # most hold + one supervision pass (ties by 10x the hold)
        cs = getattr(self.node, "chainstate", None)
        if cs is not None and getattr(cs, "_spec", None):
            with self.node.cs_main:
                cs.settle_live()
        # rate windows are normalized by the time since the previous tick
        # actually ran — a tick delayed by a long validation must not
        # read the drained backlog as a flood
        if self._last_tick is None or now <= self._last_tick:
            elapsed = self.tick_interval
        else:
            elapsed = now - self._last_tick
        self._last_tick = now
        # expire mapRelay entries in place — RPC threads insert into
        # this dict concurrently, so never rebind it
        for h, v in list(self._relay_memory.items()):
            if v[1] <= now:
                # benign cache race: snapshot iteration and pop(h, None)
                # are each GIL-atomic; a racing RPC re-insert that loses
                # its entry to this expiry sweep just re-relays later
                self._relay_memory.pop(h, None)  # BCPLINT-IGNORE[BCP008]: benign GIL-atomic cache expiry race
        # expire aged orphans (ORPHAN_TX_EXPIRE_TIME)
        for txid, entry in list(self._orphans.items()):
            if entry[3] + ORPHAN_EXPIRE_TIME <= now:
                self._remove_orphan(txid)
        for peer in list(self.peers.values()):
            quiet = now - max(peer.last_recv, peer.connected_at)
            if quiet > TIMEOUT_INTERVAL:
                log_print("net", "peer=%d inactivity timeout — dropping",
                          peer.id)
                peer.writer.close()
                continue
            if peer.handshaked and now - peer.last_ping_sent >= PING_INTERVAL:
                peer.last_ping_sent = now
                try:
                    peer.send("ping", ser_ping(secrets.randbits(64)))
                except Exception:
                    pass
            # close this tick's receive window and charge floods
            window, peer.recv_window = peer.recv_window, 0
            peer.recv_rate = window / max(elapsed, 1e-9)
            if (self.max_recv_rate and not peer.discharged
                    and peer.recv_rate > self.max_recv_rate):
                peer.flood_strikes += 1
                self.net_stats["flood_charges"] += 1
                self.misbehaving(peer, CHARGE_RECV_FLOOD, "recv-flood")
            self._check_stall(peer, now)
        # backfill deadline sweep (assumeutxo history pull supervision)
        if self._backfill:
            self._tick_backfill(now)
        # blocks orphaned by a stalled/vanished owner with no available
        # announcer at the time: hand them to an announcer that freed up
        # (hashes whose announcers are all gone are dropped inside)
        if self._unrequested:
            hashes = list(self._unrequested)
            self._unrequested.clear()
            self.net_stats["parked_handoffs"] += \
                self._dispatch_wanted(hashes, now=now)
        # wall clock, not the caller's fake `now`: the histogram measures
        # how long the tick occupied the event loop
        _TICK_H.observe(time.monotonic() - t_tick)

    def _check_stall(self, peer: Peer, now: float) -> None:
        """Block-download stall detection (net_processing.cpp's
        BLOCK_DOWNLOAD_TIMEOUT / BLOCK_STALLING_TIMEOUT pair, collapsed to
        per-peer progress tracking): a peer with blocks in flight and no
        download progress for block_download_timeout seconds is marked
        stalling, charged half the discharge threshold (visible in
        getpeerinfo), and its in-flight blocks are re-requested from
        another peer; a further timeout without redemption discharges it.
        Receiving any requested block clears the stalling mark."""
        if peer.discharged:
            return
        if peer.stalling:
            if now - peer.stalling_since > self.block_download_timeout:
                self.net_stats["evicted_stallers"] += 1
                self.misbehaving(peer, self.ban_threshold, "stalled-block")
            return
        if peer.inflight and \
                now - peer.last_block_progress > self.block_download_timeout:
            peer.stalling = True
            peer.stalling_since = now
            log_print("net", "peer=%d stalling: %d blocks in flight, no "
                      "progress for %.0fs", peer.id, len(peer.inflight),
                      now - peer.last_block_progress)
            # provisional: rolled back if the peer redeems itself by
            # delivering a still-wanted block before the fallback peer
            # does (an honest slow link must not carry the charge forever
            # — two redeemed episodes would otherwise add up to an
            # instant eviction on the second, with no timeout at all).
            # When a faster peer wins the re-request race there is
            # nothing left to redeem with and the second timeout evicts —
            # deliberately still gentler than the reference, which
            # disconnects stallers after BLOCK_STALLING_TIMEOUT (2 s)
            # with no redemption window at all.
            charge = max(1, self.ban_threshold // 2)
            peer.stall_charge = charge
            self.misbehaving(peer, charge, "stalled-block")
            self._reassign_inflight(peer, now, stalled=True)

    # -- misbehavior ledger (net_processing.cpp Misbehaving) ------------

    # caps on the reason-keyed ledger dicts: reason strings can embed
    # attacker-chosen values (e.g. "oversized payload <N>"), so both the
    # key length and the number of distinct keys are bounded — overflow
    # buckets into "other" instead of growing without limit
    MAX_REASON_LEN = 48
    MAX_REASON_KEYS = 64

    @classmethod
    def _reason_key(cls, reason: str, existing: dict) -> str:
        key = reason[:cls.MAX_REASON_LEN]
        if key in existing or len(existing) < cls.MAX_REASON_KEYS:
            return key
        return "other"

    def misbehaving(self, peer: Peer, score: int, reason: str) -> None:
        """Charge ``score`` to the peer's ban-score ledger; at or above
        the discharge threshold the peer is evicted (connection closed).
        Banning stays operator-driven (setban) — everything dials loopback
        here, and auto-banning 127.0.0.1 would take out every future peer
        on the host."""
        peer.ban_score += score
        key = self._reason_key(reason, peer.charges)
        peer.charges[key] = peer.charges.get(key, 0) + score
        self.net_stats["misbehavior_charges"] += 1
        log_print("net", "peer=%d misbehaving (+%d => %d): %s",
                  peer.id, score, peer.ban_score, reason)
        if peer.ban_score >= self.ban_threshold and not peer.discharged:
            peer.discharged = True
            self.net_stats["discharged_peers"] += 1
            key = self._reason_key(reason, self.discharge_reasons)
            self.discharge_reasons[key] = \
                self.discharge_reasons.get(key, 0) + 1
            log_print("net", "peer=%d discharged at %d (threshold %d) — "
                      "evicting", peer.id, peer.ban_score, self.ban_threshold)
            try:
                peer.writer.close()
            except Exception:
                pass

    # -- block-download bookkeeping -------------------------------------

    def _request_blocks(self, peer: Peer, hashes: list[bytes],
                        now: Optional[float] = None) -> int:
        """Send one getdata for every hash not already in flight and
        account it against the peer (vBlocksInFlight). Returns how many
        hashes were actually requested — callers tallying re-request
        counters must not count the already-in-flight ones."""
        if now is None:
            now = time.time()
        fresh = [h for h in hashes if h not in self._requested_blocks]
        if not fresh:
            return 0
        # start the stall clock only when the peer goes from idle to owing
        # blocks — while it already owes, only an actual ARRIVAL refreshes
        # the clock (_note_block_arrival). Refreshing on every send would
        # let a peer trickle one new header per timeout window and hold
        # its growing in-flight set hostage forever.
        if not peer.inflight:
            peer.last_block_progress = now
        for h in fresh:
            self._requested_blocks[h] = peer.id
            peer.inflight.add(h)
            self._unrequested.discard(h)
            # every getdata target is an announcer of the hash — keeps
            # the sources invariant for re-request routing
            self._block_sources.setdefault(h, set()).add(peer.id)
        try:
            peer.send("getdata", ser_inv([(MSG_BLOCK, h) for h in fresh]))
        except Exception:
            pass
        return len(fresh)

    def _request_or_park(self, peer: Peer, hashes: list[bytes]) -> None:
        """getdata the hashes from ``peer`` unless it is already marked
        stalling or discharged — a known-bad peer must never re-reserve a
        download against itself (the stall-and-reannounce cycle buys an
        extra timeout of sync delay per round). Parked hashes carry the
        peer as an announcer so _tick can route them once it redeems (or
        to any other announcer)."""
        if peer.stalling or peer.discharged:
            for h in hashes:
                self._block_sources.setdefault(h, set()).add(peer.id)
            self._unrequested.update(hashes)
        else:
            self._request_blocks(peer, hashes)

    # consecutive backfill deadline misses before a peer is struck out
    # of the backfill rotation (redeemed by delivering any wanted block)
    BACKFILL_EVICT_STRIKES = 3

    def request_backfill(self, hashes: list[bytes]) -> None:
        """Pull specific historical blocks (assumeutxo background sync).

        Header sync can't drive this download: the snapshot node's locator
        already contains the snapshot tip, so peers announce nothing below
        it — the verify thread names the heights it is missing instead.
        Thread-safe (called from the snapshot-verify thread); chunks are
        spread round-robin across live peers and from there inherit all of
        the normal in-flight dedupe, stall detection and re-request
        routing — plus a per-hash backfill deadline (backfilltimeout,
        much shorter than the stall window) so a dead peer can't wedge
        the shadow-validation thread: _tick_backfill retries elsewhere."""
        if not hashes:
            return
        wanted = list(hashes)

        def _go() -> None:
            self._backfill_dispatch(wanted, time.time())

        if self.loop is None:
            _go()  # unit tests drive connman with no event loop
        else:
            self.loop.call_soon_threadsafe(_go)

    def _backfill_peers(self, exclude: int = -1) -> list[Peer]:
        """Peers eligible to serve a backfill pull. Struck-out peers are
        skipped while any alternative exists; when every live peer is
        struck out they are used anyway — a degraded pull beats a wedged
        one, and a delivery un-strikes the peer."""
        live = [p for p in self.peers.values()
                if p.handshaked and not p.stalling and not p.discharged
                and p.id != exclude]
        fresh = [p for p in live if p.id not in self._backfill_evicted]
        return fresh if fresh else live

    def _backfill_dispatch(self, wanted: list[bytes], now: float) -> None:
        boff = lambda: Backoff(base=0.25, factor=2.0, maximum=5.0,  # noqa: E731
                               rng=self._rng)
        for h in wanted:
            self._backfill.setdefault(h, {
                "peer": -1, "deadline": now + self.backfill_timeout,
                "boff": boff(), "retry_at": 0.0,
            })
        peers = self._backfill_peers()
        if not peers:
            # no usable peer yet — park them; every future announcer
            # (or redeemed staller) picks them up via _tick
            self._unrequested.update(wanted)
            return
        for i, peer in enumerate(peers):
            chunk = [h for h in wanted[i::len(peers)]
                     if h not in self._requested_blocks]
            if chunk:
                self._request_blocks(peer, chunk, now=now)
                for h in chunk:
                    self._backfill[h]["peer"] = peer.id

    def _tick_backfill(self, now: float) -> None:
        """Per-tick backfill deadline sweep: expire overdue pulls, strike
        their owners, and re-request each hash from the next eligible
        peer after a jittered Backoff pause (the pause keeps a flapping
        peer set from being hammered in lockstep)."""
        for h, entry in list(self._backfill.items()):
            owner_id = self._requested_blocks.get(h)
            if owner_id is None and h not in self._unrequested \
                    and not entry["retry_at"]:
                # delivered (or dropped) through the normal path — retire
                self._backfill.pop(h, None)
                continue
            if entry["retry_at"]:
                if now >= entry["retry_at"]:
                    entry["retry_at"] = 0.0
                    self._backfill_retry(h, entry, now)
                continue
            if now < entry["deadline"]:
                continue
            # deadline fired: tear the hash off its owner and schedule
            # the retry; the owner is struck (evicted from the backfill
            # rotation at BACKFILL_EVICT_STRIKES)
            self.net_stats["backfill_retries"] += 1
            if owner_id is not None:
                owner = self.peers.get(owner_id)
                if owner is not None:
                    owner.inflight.discard(h)
                strikes = self._backfill_strikes.get(owner_id, 0) + 1
                self._backfill_strikes[owner_id] = strikes
                if strikes >= self.BACKFILL_EVICT_STRIKES \
                        and owner_id not in self._backfill_evicted:
                    self._backfill_evicted.add(owner_id)
                    self.net_stats["backfill_peer_evictions"] += 1
                    log_print("net", "peer=%d struck out of backfill "
                              "rotation (%d missed deadlines)",
                              owner_id, strikes)
                entry["peer"] = owner_id
            self._requested_blocks.pop(h, None)
            self._unrequested.discard(h)
            entry["retry_at"] = now + entry["boff"].next()

    def cancel_backfill(self) -> None:
        """Abandon every outstanding backfill pull (ISSUE 17): the shadow
        validator hard-aborted (epoch-digest divergence, rejected block or
        final digest mismatch), so the history it was naming is for a
        chainstate that will never be promoted — keeping the requests
        alive would waste peer goodput and hold getdata reservations on a
        node that is about to shut down for manual intervention.
        Thread-safe like request_backfill."""

        def _go() -> None:
            for h in list(self._backfill):
                owner_id = self._requested_blocks.pop(h, None)
                if owner_id is not None:
                    owner = self.peers.get(owner_id)
                    if owner is not None:
                        owner.inflight.discard(h)
                self._unrequested.discard(h)
            n = len(self._backfill)
            self._backfill.clear()
            if n:
                log_print("net", "backfill cancelled: %d outstanding "
                          "pull(s) abandoned", n)

        if self.loop is None:
            _go()
        else:
            self.loop.call_soon_threadsafe(_go)

    def _backfill_retry(self, h: bytes, entry: dict, now: float) -> None:
        peers = self._backfill_peers(exclude=entry["peer"])
        if not peers:
            self._unrequested.add(h)  # parked; _tick hands it out later
            return
        peer = peers[self._rng.randrange(len(peers))]
        if self._request_blocks(peer, [h], now=now):
            entry["peer"] = peer.id
            entry["deadline"] = now + self.backfill_timeout

    def _note_block_arrival(self, peer: Peer, h: bytes,
                            wire_bytes: int = 0,
                            now: Optional[float] = None) -> None:
        """A block landed (full, compact, or reconstructed): clear the
        in-flight entry. Only a block the peer actually OWED counts as
        download progress / stall redemption — an unsolicited push (e.g.
        replaying a block we already have, like genesis) must not refresh
        the stall clock, or a withholding peer could keep its reserved
        getdata hashes hostage forever by feeding duplicates. The hash may
        be charged to a DIFFERENT peer (a reassigned download whose
        original owner finally delivered): clear the recorded owner's
        in-flight entry too, or that owner would be falsely marked
        stalling over a block we already have."""
        if self._backfill.pop(h, None) is not None:
            # a delivered backfill block redeems the deliverer's strikes
            # and re-admits it to the backfill rotation
            self._backfill_strikes.pop(peer.id, None)
            self._backfill_evicted.discard(peer.id)
        owner_id = self._requested_blocks.pop(h, None)
        parked = h in self._unrequested
        self._unrequested.discard(h)
        # _block_sources is NOT dropped here: arrival precedes validation,
        # and a poisoned delivery (garbage body under a wanted header)
        # re-parks the hash — the surviving announcers are where the
        # re-request goes. _process_block_obj drops the entry once the
        # block really lands.
        # progress = delivering a block the node actually WANTED (in
        # flight with anyone, or parked awaiting a peer) — a replayed
        # known block scores nothing
        useful = owner_id is not None or parked or h in peer.inflight
        peer.inflight.discard(h)
        if owner_id is not None and owner_id != peer.id:
            owner = self.peers.get(owner_id)
            if owner is not None:
                owner.inflight.discard(h)
        if useful:
            # solicited download traffic is exempt from the flood ceiling
            # — we asked for these bytes, and an honest peer serving our
            # getdata at wire speed must never be charged for it
            if wire_bytes:
                peer.recv_window = max(0, peer.recv_window - wire_bytes)
            peer.last_block_progress = time.time() if now is None else now
            if peer.stalling:
                peer.stalling = False  # redeemed before the final timeout
                # roll the provisional charge back off the ledger: the
                # contract is "a further timeout WITHOUT redemption
                # discharges" — a redeemed episode must not leave the
                # peer one slow block away from instant eviction
                if peer.stall_charge and not peer.discharged:
                    peer.ban_score = max(
                        0, peer.ban_score - peer.stall_charge)
                    left = peer.charges.get("stalled-block", 0) \
                        - peer.stall_charge
                    if left > 0:
                        peer.charges["stalled-block"] = left
                    else:
                        peer.charges.pop("stalled-block", None)
                peer.stall_charge = 0

    def _reassign_inflight(self, loser: Peer, now: Optional[float] = None,
                           stalled: bool = False) -> None:
        """Move every block the peer still owes onto other ANNOUNCERS of
        those blocks (via _dispatch_wanted); hashes whose announcers are
        all busy are parked for _tick, hashes nobody else ever announced
        are dropped. ``stalled`` keys which counter the move lands in —
        gettpuinfo's stall_rerequests must reflect actual stall evictions,
        not benign peer churn, or operator dashboards read ordinary
        disconnects as an attack."""
        hashes = [h for h, pid in self._requested_blocks.items()
                  if pid == loser.id]
        loser.inflight.clear()
        for h in hashes:
            self._requested_blocks.pop(h, None)
        if not hashes:
            return
        moved = self._dispatch_wanted(hashes, exclude=loser.id, now=now)
        if moved:
            counter = ("stall_rerequests" if stalled
                       else "disconnect_rerequests")
            self.net_stats[counter] += moved
            log_print("net", "re-requested %d of %d blocks owed by "
                      "peer=%d%s", moved, len(hashes), loser.id,
                      ", stalled" if stalled else "")

    def _dispatch_wanted(self, hashes: list[bytes],
                         exclude: Optional[int] = None,
                         now: Optional[float] = None) -> int:
        """Route wanted block hashes to live peers that ANNOUNCED them —
        the only peers it is fair to hold accountable for delivery.
        Requesting from a non-announcer and then stall-charging it would
        let one attacker's undeliverable announcements cascade-evict
        every honest peer. Per hash: request from the least-loaded
        available announcer; park (``_unrequested``) while every announcer
        is busy; forget the download once no announcer is connected at
        all — if the block matters, a future headers/cmpctblock
        announcement from a peer that has it starts it over. Returns the
        number of hashes actually re-requested."""
        by_target: dict[int, list[bytes]] = {}
        for h in hashes:
            if h in self._requested_blocks:
                continue  # already in flight with another owner
            src = self._block_sources.get(h)
            if src is not None:
                src.intersection_update(self.peers)  # prune dead peers
            if not src:
                self._block_sources.pop(h, None)
                self._unrequested.discard(h)
                log_print("net", "dropping block %s — no announcer left",
                          hash_to_hex(h)[:16])
                continue
            candidates = [
                self.peers[pid] for pid in src
                if pid != exclude and self.peers[pid].handshaked
                and not self.peers[pid].discharged
                and not self.peers[pid].stalling
            ]
            if not candidates:
                self._unrequested.add(h)  # until an announcer frees up
                continue
            target = min(candidates, key=lambda p: len(p.inflight))
            by_target.setdefault(target.id, []).append(h)
        moved = 0
        for pid, hs in by_target.items():
            # count only what actually went out — a hash already in
            # flight elsewhere is filtered inside, and counting it would
            # inflate the operator-facing re-request counters
            moved += self._request_blocks(self.peers[pid], hs, now)
        return moved

    # -- orphan pool (mapOrphanTransactions) ----------------------------

    def _add_orphan(self, peer: Optional[Peer], tx: CTransaction) -> None:
        size = len(tx.serialize())
        if size > MAX_ORPHAN_TX_SIZE:
            log_print("net", "ignoring oversized orphan %s (%d bytes)",
                      tx.txid_hex[:16], size)
            return
        if tx.txid in self._orphans:
            return
        self._orphans[tx.txid] = (
            tx, peer.id if peer is not None else 0, size, time.time())
        self._orphan_bytes += size
        # LimitOrphanTxSize: evict seeded-random victims until both the
        # count cap and the byte budget hold
        while (len(self._orphans) > MAX_ORPHAN_TX
               or self._orphan_bytes > MAX_ORPHAN_BYTES):
            victim = self._rng.choice(list(self._orphans))
            self._remove_orphan(victim)
            self.net_stats["orphans_evicted"] += 1
        log_print("net", "orphan tx %s parked (%d pooled, %d bytes)",
                  tx.txid_hex[:16], len(self._orphans), self._orphan_bytes)

    def _remove_orphan(self, txid: bytes) -> None:
        entry = self._orphans.pop(txid, None)
        if entry is not None:
            self._orphan_bytes -= entry[2]

    def _erase_sources_for(self, peer_id: int) -> None:
        """Drop a disconnected peer from every announcement-source set;
        a hash with no announcer left that isn't actively tracked is
        forgotten entirely (this keeps the documented invariant that
        entries die with their last announcer — a pending-cmpctblock
        hash, for example, has no other pruning site)."""
        for h in list(self._block_sources):
            src = self._block_sources[h]
            src.discard(peer_id)
            if not src and h not in self._requested_blocks:
                self._block_sources.pop(h, None)
                self._unrequested.discard(h)

    def _erase_orphans_for(self, peer_id: int) -> None:
        """EraseOrphansFor: a disconnected peer's parked orphans go with it
        (per-peer attribution keeps one peer from squatting the pool)."""
        mine = [txid for txid, e in self._orphans.items() if e[1] == peer_id]
        for txid in mine:
            self._remove_orphan(txid)
        if mine:
            log_print("net", "erased %d orphans from peer=%d",
                      len(mine), peer_id)

    def _telemetry_families(self) -> list:
        """Registry collector: net_stats counters, pool/banlist gauges,
        and per-peer receive-rate gauges (live peers only — labels die
        with their peer, unlike a mutable labeled gauge would)."""
        out = tm.flat_families("bcp_net", self.net_stats, typ="counter",
                              help="p2p/connman supervision counters")
        out.append({"name": "bcp_net_peers", "type": "gauge",
                    "help": "Connected peers",
                    "samples": [({}, len(self.peers))]})
        out.append({"name": "bcp_net_orphans", "type": "gauge",
                    "help": "Parked orphan transactions",
                    "samples": [({}, len(self._orphans))]})
        out.append({"name": "bcp_net_banned", "type": "gauge",
                    "help": "Banlist entries",
                    "samples": [({}, len(self._banned))]})
        peers = list(self.peers.values())
        if peers:
            out.append({
                "name": "bcp_peer_recv_rate_bytes", "type": "gauge",
                "help": "Per-peer receive rate over the last tick window "
                        "(bytes/sec)",
                "samples": [({"peer": str(p.id)}, round(p.recv_rate, 1))
                            for p in peers],
            })
        return out

    def net_snapshot(self) -> dict:
        """gettpuinfo 'net' section: the supervision counters an operator
        needs to see why peers are being charged and evicted."""
        return {
            **self.net_stats,
            "discharge_reasons": dict(self.discharge_reasons),
            "orphans": {"count": len(self._orphans),
                        "bytes": self._orphan_bytes},
            "requested_blocks": len(self._requested_blocks),
            "unrequested_blocks": len(self._unrequested),
            "banned": len(self._banned),
            "ban_threshold": self.ban_threshold,
            "block_download_timeout": self.block_download_timeout,
            "max_recv_rate": self.max_recv_rate,
        }

    async def _start_server(self) -> None:
        self._server = await asyncio.start_server(
            self._on_inbound, self.bind_host, self.listen_port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log_print("net", "P2P listening on %s:%d", self.bind_host, self.port)

    def close(self) -> None:
        # the 'net' collector holds a bound method of this connman; a
        # closed P2P stack must not stay reachable through the registry
        tm.REGISTRY.unregister_collector("net")
        if self.loop is None:
            return

        def _shutdown():
            for peer in list(self.peers.values()):
                peer.writer.close()
            if self._server is not None:
                self._server.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(_shutdown)
        self._thread.join(10)
        try:
            self.addrman.save(self._peers_path)  # DumpAddresses
        except OSError as e:
            log_printf("peers.json save failed: %r", e)

    # -- dialing --------------------------------------------------------

    def connect_to(self, host: str, port: int) -> None:
        asyncio.run_coroutine_threadsafe(self._dial(host, port), self.loop)

    async def _dial(self, host: str, port: int) -> None:
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError as e:
            log_print("net", "connect to %s:%d failed: %s", host, port, e)
            return
        peer = Peer(self, reader, writer, outbound=True)
        self.peers[peer.id] = peer
        peer.send("version", self._version_payload().serialize())
        asyncio.ensure_future(self._peer_loop(peer))

    async def _on_inbound(self, reader, writer) -> None:
        peername = writer.get_extra_info("peername") or ("?", 0)
        if self.is_banned(peername[0]) or \
                len(self.peers) >= self.max_connections:
            writer.close()
            return
        peer = Peer(self, reader, writer, outbound=False)
        self.peers[peer.id] = peer
        await self._peer_loop(peer)

    # -- ban list (src/banman.cpp) --------------------------------------

    def _load_banlist(self) -> dict[str, float]:
        """LoadBanlist: read banlist.json, pruning entries that expired
        while the node was down (SweepBanned)."""
        raw = read_json(self._banlist_path, default=None)
        if not isinstance(raw, dict):
            return {}
        now = time.time()
        try:
            banned = {
                str(ip): float(until)
                for ip, until in raw.get("banned", {}).items()
                if float(until) > now
            }
        except (AttributeError, TypeError, ValueError):
            # structurally wrong sidecar (hand-edited, torn writer):
            # startup must never die on it — log and start clean
            log_printf("banlist.json malformed — ignoring")
            return {}
        if banned:
            log_print("net", "loaded %d banned hosts from banlist.json",
                      len(banned))
        return banned

    def _snapshot_banlist(self) -> tuple[int, dict[str, float]]:
        """Caller holds _ban_lock: bump the mutation sequence and copy the
        dict for persisting after the lock is released."""
        self._ban_seq += 1
        return self._ban_seq, dict(self._banned)

    def _persist_banlist(self, seq: int, snap: dict[str, float]) -> None:
        """DumpBanlist: every mutation (setban add/remove, clearbanned)
        writes through so a crash never loses an operator's ban. Runs
        WITHOUT _ban_lock — the fsync must not stall the event loop's
        is_banned checks; _ban_io_lock serializes writers and the seq
        check drops a snapshot that lost the race to a newer one."""
        with self._ban_io_lock:
            if seq <= self._ban_saved_seq:
                return  # a newer snapshot already reached the disk
            self._ban_saved_seq = seq
            try:
                atomic_write_json(self._banlist_path,
                                  {"version": 1, "banned": snap})
            except OSError as e:
                log_printf("banlist.json save failed: %r", e)

    def is_banned(self, ip: str) -> bool:
        with self._ban_lock:
            until = self._banned.get(ip)
            if until is None:
                return False
            if time.time() > until:
                self._banned.pop(ip, None)
                return False
            return True

    def ban(self, ip: str, bantime: int = 0) -> None:
        with self._ban_lock:
            self._banned[ip] = time.time() + (bantime or self.bantime)
            seq, snap = self._snapshot_banlist()
        self._persist_banlist(seq, snap)
        # drop any live connections from that host
        def _do():
            for peer in list(self.peers.values()):
                if peer.addr.rsplit(":", 1)[0] == ip:
                    peer.writer.close()
        if self.loop is not None:
            self.loop.call_soon_threadsafe(_do)

    def unban(self, ip: str) -> bool:
        with self._ban_lock:
            hit = self._banned.pop(ip, None) is not None
            if not hit:
                return False
            seq, snap = self._snapshot_banlist()
        self._persist_banlist(seq, snap)
        return True

    def banned(self) -> dict[str, float]:
        now = time.time()
        # prune + snapshot under the lock: an unlocked rebind here would
        # drop a ban a concurrent setban just inserted (lost update that
        # the next locked mutation would then persist to disk)
        with self._ban_lock:
            self._banned = {ip: t for ip, t in self._banned.items()
                            if t > now}
            return dict(self._banned)

    def clear_banned(self) -> None:
        with self._ban_lock:
            self._banned.clear()
            seq, snap = self._snapshot_banlist()
        self._persist_banlist(seq, snap)

    def ping_all(self) -> None:
        def _do():
            for peer in self.peers.values():
                if peer.handshaked:
                    try:
                        peer.send("ping", ser_ping(secrets.randbits(64)))
                    except Exception:
                        pass
        if self.loop is not None:
            self.loop.call_soon_threadsafe(_do)

    def disconnect(self, addr: str) -> None:
        def _do():
            for peer in list(self.peers.values()):
                if peer.addr == addr:
                    peer.writer.close()
        self.loop.call_soon_threadsafe(_do)

    def _version_payload(self) -> VersionPayload:
        with self.node.cs_main:
            height = self.node.chainstate.tip().height
        return VersionPayload(nonce=self._nonce, start_height=height)

    # -- per-peer receive loop -----------------------------------------

    async def _peer_loop(self, peer: Peer) -> None:
        try:
            while True:
                raw_header = await peer.reader.readexactly(HEADER_SIZE)
                header = MessageHeader.parse(raw_header, self.magic)
                payload = await peer.reader.readexactly(header.length)
                check_payload(header, payload)
                peer.bytes_recv += HEADER_SIZE + header.length
                self.bytes_recv += HEADER_SIZE + header.length
                peer.recv_window += HEADER_SIZE + header.length
                peer.last_recv = time.time()
                await self._process_message(peer, header.command, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # peer hung up
        except NetMessageError as e:
            # the raise ends the connection regardless; the charge still
            # goes through the ledger so counters/reasons are recorded
            # (an un-annotated NetMessageError scores 100 = immediate
            # discharge, the historical behavior). score=0 marks benign
            # protocol disconnects (self-connect, duplicate version) that
            # must not pollute the attack counters.
            score = getattr(e, "score", 100)
            if score > 0:
                self.misbehaving(peer, score, str(e))
            else:
                log_print("net", "peer=%d disconnecting: %s", peer.id, e)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log_printf("P2P internal error peer=%d: %r", peer.id, e)
        finally:
            self.peers.pop(peer.id, None)
            # per-peer attribution: its parked orphans go with it, and its
            # in-flight block requests move to another peer (or are freed
            # for re-announcement) so sync keeps making progress
            self._erase_orphans_for(peer.id)
            self._reassign_inflight(peer)
            self._erase_sources_for(peer.id)
            # peer ids are never reused — drop its backfill ledger rows
            self._backfill_strikes.pop(peer.id, None)
            self._backfill_evicted.discard(peer.id)
            try:
                peer.writer.close()
            except Exception:
                pass

    # -- message processing (ProcessMessage) ---------------------------

    async def _process_message(self, peer: Peer, command: str,
                               payload: bytes) -> None:
        log_print("net", "received: %s (%d bytes) peer=%d",
                  command, len(payload), peer.id)
        if INJECTOR.armed_for(NET_SITE):
            # BCP_FAULT_OPS=net: fail-rate models message loss at the
            # dispatch boundary, latency-spike a slow link (chaos drills).
            # Latency is awaited here — on_call's blocking sleep would
            # stall the whole event loop, not one link.
            lat = INJECTOR.latency(NET_SITE)
            if lat:
                await asyncio.sleep(lat)
            else:
                try:
                    INJECTOR.on_call(NET_SITE)
                except InjectedFault:
                    self.net_stats["net_faults_injected"] += 1
                    log_print("net", "dropped %s from peer=%d (injected "
                              "net fault)", command, peer.id)
                    return
        handler = getattr(self, f"_msg_{command}", None)
        if handler is None:
            return  # unknown messages are ignored, like the reference
        result = handler(peer, payload)
        if asyncio.iscoroutine(result):  # bulk-serving handlers drain
            await result

    def _msg_version(self, peer: Peer, payload: bytes) -> None:
        # score=0: benign protocol hygiene, not misbehavior — the raise
        # still ends the connection, but an operator addnode'ing the
        # node's own address must not show up as a stream of phantom
        # discharges in the attack counters
        if peer.version is not None:
            raise NetMessageError("duplicate version", score=0)
        version = VersionPayload.parse(payload)
        if version.nonce == self._nonce:
            raise NetMessageError("connected to self", score=0)
        peer.version = version
        peer.relay_txs = version.relay
        if not peer.outbound:
            peer.send("version", self._version_payload().serialize())
        peer.send("verack")

    def _msg_verack(self, peer: Peer, payload: bytes) -> None:
        peer.got_verack = True
        # BIP130: ask for headers-first block announcements (we already
        # process unsolicited headers via _msg_headers)
        peer.send("sendheaders")
        # BIP152: offer compact-block relay, version 1, low-bandwidth
        # (announce=0: we ask peers to announce via headers/inv and pull
        # cmpctblock on demand; peers may still sendcmpct(1) at us)
        peer.send("sendcmpct", struct.pack("<BQ", 0, 1))
        # BIP133: tell the peer our relay floor so it doesn't waste invs
        peer.send("feefilter",
                  struct.pack("<Q", self.node.min_relay_fee_rate))
        if peer.outbound:
            # handshake success: promote in addrman, harvest its peers,
            # and reset the dial loop's backoff to its base interval
            host, _, port = peer.addr.rpartition(":")
            self.addrman.good(host, int(port))
            self._dial_backoff.reset()
            peer.send("getaddr")
        # start headers sync (the reference sends getheaders on verack)
        with self.node.cs_main:
            locator = self.node.chainstate.chain.get_locator()
        peer.send("getheaders", ser_getheaders(locator))

    def _msg_ping(self, peer: Peer, payload: bytes) -> None:
        peer.send("pong", ser_ping(deser_ping(payload)))

    def _msg_pong(self, peer: Peer, payload: bytes) -> None:
        pass

    def _msg_sendheaders(self, peer: Peer, payload: bytes) -> None:
        """BIP130: peer wants new-block announcements as headers messages
        instead of inv (net_processing.cpp SENDHEADERS handling)."""
        peer.prefers_headers = True

    def _msg_getheaders(self, peer: Peer, payload: bytes) -> None:
        locator, hash_stop = deser_getheaders(payload)
        with self.node.cs_main:
            cs = self.node.chainstate
            start = None
            for h in locator:
                idx = cs.block_index.get(h)
                if idx is not None and idx in cs.chain:
                    start = idx
                    break
            height = (start.height + 1) if start is not None else 0
            headers = []
            while len(headers) < MAX_HEADERS_RESULTS:
                idx = cs.chain[height]
                if idx is None:
                    break
                headers.append(idx.header)
                if idx.hash == hash_stop:
                    break
                height += 1
        peer.send("headers", ser_headers(headers))

    # headers batches below this size aren't worth a device dispatch for
    # the PoW pre-filter (the per-header host check in accept_block_header
    # covers them anyway)
    HEADERS_POW_BATCH_MIN = 16

    def _msg_headers(self, peer: Peer, payload: bytes) -> None:
        headers = deser_headers(payload)
        if not headers:
            return
        if len(headers) >= self.HEADERS_POW_BATCH_MIN:
            # batched context-free PoW over the whole announcement in one
            # supervised dispatch (consensus/pow.check_headers_pow_batch):
            # a 2000-header IBD batch with any bad-PoW header is rejected
            # before per-header context work, and a dead backend degrades
            # to host hashing with the identical verdict
            ok = check_headers_pow_batch(
                [h.serialize() for h in headers], self.node.params.consensus
            )
            if not all(ok):
                raise NetMessageError("invalid header: high-hash")
        want = []  # ordered for the getdata; the set gives O(1) dedupe
        want_set = set()
        truncated = False  # batch cut short on a clock-subjective reject
        progressed = False  # batch taught us at least one NEW header
        with self.node.cs_main:
            cs = self.node.chainstate
            for header in headers:
                try:
                    # newness via index growth, not a pre-hash — an extra
                    # get_hash() here would double-SHA every header of a
                    # 2000-header IBD batch a second time
                    before = len(cs.block_index)
                    idx = cs.accept_block_header(header)
                    progressed = progressed or len(cs.block_index) > before
                except BlockValidationError as e:
                    if e.reason == "prev-blk-not-found":
                        # out of order — graduated misbehavior, rate-limited
                        # (MAX_UNCONNECTING_HEADERS): honest peers hit this
                        # in bursts around reorgs/our IBD and their counter
                        # resets on every NEW connecting header, while a
                        # garbage-replayer's only ever grows, accumulating
                        # to the threshold. Then restart sync from our
                        # locator. Nothing was reserved for this batch:
                        # getdata bookkeeping happens after the loop.
                        peer.unconnecting_headers += 1
                        if peer.unconnecting_headers % \
                                self.max_unconnecting == 0:
                            self.misbehaving(
                                peer, CHARGE_NONCONNECTING_HEADERS,
                                "non-connecting-headers")
                            if peer.discharged:
                                return
                        locator = cs.chain.get_locator()
                        peer.send("getheaders", ser_getheaders(locator))
                        return
                    if e.reason == "time-too-new":
                        # clock-subjective: as likely our skewed clock as
                        # their bad header (the block path exempts it for
                        # the same reason) — stop processing the batch
                        # but keep the connection uncharged; the header
                        # becomes acceptable as our clock catches up and
                        # the peer re-announces. truncated guards the
                        # continuation getheaders below: headers[-1] was
                        # never accepted, so it has no index entry.
                        truncated = True
                        break
                    raise NetMessageError(f"invalid header: {e.reason}") from None
                if not (idx.status & BlockStatus.HAVE_DATA):
                    if idx.hash in self._requested_blocks:
                        # fallback announcer for an in-flight download —
                        # the stall detector re-requests from it. (For
                        # fresh hashes the source is registered at
                        # dispatch below, not here: a batch cut short by
                        # the non-connecting return never dispatches, and
                        # registering then would leak entries that no
                        # pruning site ever visits.)
                        self._block_sources.setdefault(
                            idx.hash, set()).add(peer.id)
                    elif idx.hash not in want_set:
                        want.append(idx.hash)
                        want_set.add(idx.hash)
            # only a batch that taught us at least one NEW connecting
            # header redeems the counter. Resetting per accepted header
            # would let an attacker evade the graduated charge by
            # prepending genesis to every garbage batch (the
            # non-connecting path above returns before reaching here),
            # and resetting on any completed batch would let it
            # alternate garbage batches with replays of known headers —
            # replaying what we already know is not redemption.
            if progressed:
                peer.unconnecting_headers = 0
        if want:
            self._request_or_park(peer, want)
        if len(headers) == MAX_HEADERS_RESULTS and not truncated:  # more?
            with self.node.cs_main:
                locator = self.node.chainstate.chain.get_locator(
                    self.node.chainstate.block_index[headers[-1].get_hash()]
                )
            peer.send("getheaders", ser_getheaders(locator))

    def _msg_inv(self, peer: Peer, payload: bytes) -> None:
        items = deser_inv(payload)
        want_tx = []
        ask_headers = False
        with self.node.cs_main:
            cs = self.node.chainstate
            for inv_type, h in items:
                peer.known_invs.add(h)
                if inv_type == MSG_BLOCK:
                    idx = cs.block_index.get(h)
                    if idx is None or not (idx.status & BlockStatus.HAVE_DATA):
                        ask_headers = True  # headers-first sync
                elif inv_type == MSG_TX:
                    if h not in self.node.mempool:
                        want_tx.append(h)
            locator = cs.chain.get_locator() if ask_headers else None
        if ask_headers:
            peer.send("getheaders", ser_getheaders(locator))
        if want_tx:
            peer.send("getdata", ser_inv([(MSG_TX, h) for h in want_tx]))

    async def _msg_getdata(self, peer: Peer, payload: bytes) -> None:
        # async handler: a 2000-block IBD getdata would otherwise buffer
        # every serialized block in the transport at once — drain after each
        # send for backpressure (the reference bounds this with its
        # per-peer send-buffer limit, net.cpp nSendBufferMaxSize)
        items = deser_inv(payload)
        for inv_type, h in items:
            if inv_type == MSG_BLOCK:
                with self.node.cs_main:
                    raw = self.node.block_store.get_block(h)
                if raw is not None:
                    peer.send("block", raw)
                    await peer.writer.drain()
            elif inv_type == MSG_CMPCT_BLOCK:
                with self.node.cs_main:
                    raw = self.node.block_store.get_block(h)
                if raw is not None:
                    from .compact import HeaderAndShortIDs

                    peer.send("cmpctblock", HeaderAndShortIDs.from_block(
                        CBlock.from_bytes(raw)).serialize())
                    await peer.writer.drain()
            elif inv_type == MSG_FILTERED_BLOCK:
                # BIP37: merkleblock + the matched txs (net_processing.cpp
                # ProcessGetData MSG_FILTERED_BLOCK branch). No filter
                # loaded → ignore the request, like the reference.
                if peer.bloom_filter is None:
                    continue
                with self.node.cs_main:
                    raw = self.node.block_store.get_block(h)
                    if raw is None:
                        continue
                    block = CBlock.from_bytes(raw)
                    from ..consensus.merkleblock import CMerkleBlock

                    mb = CMerkleBlock.from_block(block, peer.bloom_filter)
                peer.send("merkleblock", mb.serialize())
                # always follow with the matched txs: once mined they are
                # gone from the mempool, so a skipped send here would be
                # the peer's last chance to ever obtain them
                matched = set(mb.matched_txids)
                for tx in block.vtx:
                    if tx.txid in matched:
                        peer.send("tx", tx.serialize())
                await peer.writer.drain()
            elif inv_type == MSG_TX:
                with self.node.cs_main:
                    tx = self.node.mempool.get_tx(h)
                if tx is None:
                    # mapRelay: a just-mined tx can still be served
                    kept = self._relay_memory.get(h)
                    if kept is not None and kept[1] > time.time():
                        tx = kept[0]
                if tx is not None:
                    peer.send("tx", tx.serialize())
                    await peer.writer.drain()

    def _msg_block(self, peer: Peer, payload: bytes) -> None:
        try:
            block = CBlock.from_bytes(payload)
        except Exception:
            raise NetMessageError("undecodable block") from None
        self._note_block_arrival(peer, block.get_hash(),
                                 wire_bytes=HEADER_SIZE + len(payload))
        self._process_block_obj(peer, block)

    def _msg_tx(self, peer: Peer, payload: bytes) -> None:
        try:
            tx = CTransaction.from_bytes(payload)
        except Exception:
            raise NetMessageError("undecodable tx") from None
        peer.known_invs.add(tx.txid)
        with self.node.cs_main:
            self._accept_tx(peer, tx)

    def _accept_tx(self, peer: Peer, tx: CTransaction) -> None:
        """ATMP + the mapOrphanTransactions dance (net_processing.cpp:~900):
        a tx with unknown inputs parks in a bounded orphan pool and is
        retried when any parent is accepted; accepted txs relay onward and
        trigger orphan reprocessing. Caller holds cs_main."""
        try:
            self.node.accept_to_mempool(tx)
        except MempoolError as e:
            if e.reason == "missing-inputs":
                self._add_orphan(peer, tx)
            else:
                log_print("net", "tx %s rejected: %s", tx.txid_hex[:16], e.reason)
                if peer is not None:
                    code = (REJECT_INSUFFICIENTFEE
                            if "fee" in e.reason else REJECT_INVALID)
                    self._send_reject(peer, "tx", code, e.reason, tx.txid)
                    # graduated charge for unambiguous consensus
                    # violations only — policy rejects (fees, limits,
                    # duplicates, standardness, the POLICY_BAD_TXNS
                    # reasons) are not misbehavior. Script failures are
                    # NEVER charged: mempool verification runs STANDARD
                    # flags (a superset of consensus — LOW_S, CLEANSTACK,
                    # MINIMALDATA...), so a "mandatory-script-verify-
                    # flag-failed" reject may be a consensus-valid tx
                    # that merely violates policy (e.g. a high-S
                    # signature), and charging it would evict honest
                    # relayers. The reference re-verifies with
                    # mandatory-only flags before punishing; lacking that
                    # second pass, the ambiguity forfeits the charge.
                    if ((e.reason.startswith("bad-txns")
                            and e.reason not in POLICY_BAD_TXNS)
                            or e.reason == "coinbase"):
                        self.misbehaving(peer, CHARGE_INVALID_TX,
                                         "invalid-tx")
            return
        self.relay_tx(tx.txid, skip_peer=peer.id if peer else 0)
        # any orphans that spend this tx can be retried now — attributed
        # to the peer that SENT each orphan (a consensus-invalid orphan
        # must charge its own relayer, not whoever supplied the parent)
        dependents = [
            e for e in self._orphans.values()
            if any(i.prevout.hash == tx.txid for i in e[0].vin)
        ]
        for orphan_tx, source_id, _size, _added in dependents:
            self._remove_orphan(orphan_tx.txid)
            self._accept_tx(self.peers.get(source_id), orphan_tx)

    def _msg_mempool(self, peer: Peer, payload: bytes) -> None:
        """BIP35 'mempool': answer with an inv of current mempool txids
        (bloom-filtered when the peer loaded one, like the reference)."""
        with self.node.cs_main:
            if peer.bloom_filter is not None:
                txids = [
                    txid for txid, e in self.node.mempool.entries.items()
                    if peer.bloom_filter.is_relevant_and_update(e.tx)
                ]
            else:
                txids = list(self.node.mempool.entries)
        if txids:
            peer.send("inv", ser_inv([(MSG_TX, h) for h in txids[:50_000]]))

    # -- BIP37 bloom filtering (net_processing.cpp FILTERLOAD/ADD/CLEAR) --

    def _msg_filterload(self, peer: Peer, payload: bytes) -> None:
        try:
            f = deser_filterload(payload)
        except Exception:
            raise NetMessageError("bad filterload") from None
        if not f.is_within_size_constraints():
            raise NetMessageError("oversized bloom filter")
        peer.bloom_filter = f
        peer.relay_txs = True

    def _msg_filteradd(self, peer: Peer, payload: bytes) -> None:
        from ..consensus.serialize import ByteReader, deser_compact_size

        try:
            r = ByteReader(payload)
            n = deser_compact_size(r)
            data = r.read_bytes(n)
        except Exception:
            raise NetMessageError("bad filteradd") from None
        # MAX_SCRIPT_ELEMENT_SIZE bound, and adding without a loaded filter
        # is misbehavior (net_processing.cpp)
        if len(data) > 520 or peer.bloom_filter is None:
            raise NetMessageError("filteradd without filter or oversized")
        peer.bloom_filter.insert(data)

    def _msg_filterclear(self, peer: Peer, payload: bytes) -> None:
        peer.bloom_filter = None
        peer.relay_txs = True  # "relay all transactions" per BIP37

    # -- BIP152 compact blocks (net_processing.cpp SENDCMPCT/CMPCTBLOCK/
    # GETBLOCKTXN/BLOCKTXN) ----------------------------------------------

    # -- addr gossip (net_processing.cpp ADDR/GETADDR, CAddrMan) ---------

    def _msg_addr(self, peer: Peer, payload: bytes) -> None:
        from .protocol import deser_addr_entries

        entries = deser_addr_entries(payload)
        now = int(time.time())
        for t, services, host, port in entries:
            if host == "::" or port == 0:
                continue
            # clamp absurd timestamps like CAddrMan (10-min penalty
            # skipped); the gossiping peer is the SOURCE — it determines
            # which 64 new buckets the entry may land in (eclipse defense)
            self.addrman.add(host, port, services, min(t, now),
                             source=peer.addr.rsplit(":", 1)[0])
        log_print("net", "peer=%d addr: %d entries (%d known)",
                  peer.id, len(entries), len(self.addrman))

    def _msg_getaddr(self, peer: Peer, payload: bytes) -> None:
        from .protocol import ser_addr_entries

        entries = [
            (a.time, a.services, a.host, a.port)
            for a in self.addrman.addresses()
        ]
        if entries:
            peer.send("addr", ser_addr_entries(entries))

    async def _open_connections_loop(self) -> None:
        """ThreadOpenConnections (net.cpp): keep dialing addrman candidates
        until the outbound target is met. Paced by the shared jittered
        exponential backoff: every dial that does not produce a handshake
        grows the next sleep (to 60 s max), and a completed handshake
        (_msg_verack) resets it — a dead or unreachable candidate set backs
        the node off instead of burning a fixed-interval dial loop."""
        while True:
            await asyncio.sleep(self._dial_backoff.next())
            outbound = [p for p in self.peers.values() if p.outbound]
            if (len(outbound) >= self.max_outbound
                    or len(self.peers) >= self.max_connections):
                self._dial_backoff.reset()  # healthy: keep the base poll
                continue
            connected = {p.addr for p in self.peers.values()}
            candidate = self.addrman.select(exclude=connected)
            if candidate is None or self.is_banned(candidate.host):
                continue
            self.addrman.attempt(candidate.host, candidate.port)
            try:
                # bound the TCP connect so one black-holed advertised
                # address can't stall the dial loop for minutes
                await asyncio.wait_for(
                    self._dial(candidate.host, candidate.port), timeout=10)
            except asyncio.TimeoutError:
                log_print("net", "dial %s:%d timed out",
                          candidate.host, candidate.port)

    def _msg_feefilter(self, peer: Peer, payload: bytes) -> None:
        """BIP133: peer's minimum announce feerate (sat/kB)."""
        if len(payload) != 8:
            raise NetMessageError("bad feefilter")
        (peer.min_fee_filter,) = struct.unpack("<Q", payload)

    def _send_reject(self, peer: Peer, message: str, code: int,
                     reason: str, h: bytes = b"") -> None:
        """BIP61 reject (net_processing.cpp PushMessage(REJECT, ...))."""
        from ..consensus.serialize import ser_compact_size

        msg = message.encode()
        rsn = reason.encode()[:111]  # MAX_REJECT_MESSAGE_LENGTH
        payload = (ser_compact_size(len(msg)) + msg + bytes([code])
                   + ser_compact_size(len(rsn)) + rsn + h)
        try:
            peer.send("reject", payload)
        except Exception:
            pass

    def _msg_reject(self, peer: Peer, payload: bytes) -> None:
        """Incoming rejects are logged, never acted on (like the
        reference's -debug=net logging of REJECT)."""
        log_print("net", "peer=%d reject: %s", peer.id, payload[:64].hex())

    def _msg_sendcmpct(self, peer: Peer, payload: bytes) -> None:
        if len(payload) != 9:
            raise NetMessageError("bad sendcmpct")
        announce, version = struct.unpack("<BQ", payload)
        if version == 1:  # other versions are ignored, like the reference
            peer.cmpct_announce = bool(announce)

    def _msg_cmpctblock(self, peer: Peer, payload: bytes) -> None:
        from .compact import BlockTransactionsRequest, HeaderAndShortIDs
        from ..consensus.serialize import ByteReader

        try:
            hsids = HeaderAndShortIDs.deserialize(ByteReader(payload))
        except Exception:
            raise NetMessageError("undecodable cmpctblock") from None
        h = hsids.header.get_hash()
        with self.node.cs_main:
            cs = self.node.chainstate
            idx = cs.block_index.get(h)
            if idx is not None and (idx.status & BlockStatus.HAVE_DATA):
                return  # already have it
            # header must be valid before we spend effort reconstructing
            try:
                cs.accept_block_header(hsids.header)
            except BlockValidationError as e:
                if e.reason == "prev-blk-not-found":
                    # can't contextually validate — fall back to headers sync
                    peer.send("getheaders",
                              ser_getheaders(cs.chain.get_locator()))
                    return
                if e.reason == "time-too-new":
                    # clock-subjective, same exemption as the headers and
                    # block paths: drop the announcement uncharged — with
                    # compact blocks as the default tip-relay mode, a
                    # skewed local clock would otherwise discharge every
                    # honest tip relayer
                    return
                raise NetMessageError(
                    f"invalid cmpctblock header: {e.reason}") from None
            # a compact announcement is a claim of having the block
            self._block_sources.setdefault(h, set()).add(peer.id)
            # map short IDs over the mempool
            from .compact import short_id, short_id_keys

            k0, k1 = short_id_keys(hsids.header, hsids.nonce)
            by_sid = {
                short_id(k0, k1, txid): e.tx
                for txid, e in self.node.mempool.entries.items()
            }
            block, missing = hsids.reconstruct(by_sid.get)
        if block is not None:
            self._note_block_arrival(peer, h,
                                     wire_bytes=HEADER_SIZE + len(payload))
            self._process_block_obj(peer, block)
            return
        if peer.pending_cmpct is not None:
            # a second announcement would orphan the in-flight
            # reconstruction — fetch the old block in full instead
            old_h = peer.pending_cmpct[0].header.get_hash()
            self._request_or_park(peer, [old_h])
        # keep the shortid->tx map so blocktxn doesn't re-hash the mempool
        peer.pending_cmpct = (hsids, by_sid)
        req = BlockTransactionsRequest(h, missing)
        peer.send("getblocktxn", req.serialize())

    def _msg_getblocktxn(self, peer: Peer, payload: bytes) -> None:
        from .compact import BlockTransactions, BlockTransactionsRequest
        from ..consensus.serialize import ByteReader

        try:
            req = BlockTransactionsRequest.deserialize(ByteReader(payload))
        except Exception:
            raise NetMessageError("bad getblocktxn") from None
        with self.node.cs_main:
            raw = self.node.block_store.get_block(req.block_hash)
        if raw is None:
            return
        block = CBlock.from_bytes(raw)
        try:
            txs = [block.vtx[i] for i in req.indexes]
        except IndexError:
            raise NetMessageError("getblocktxn index out of range") from None
        peer.send("blocktxn",
                  BlockTransactions(req.block_hash, txs).serialize())

    def _msg_blocktxn(self, peer: Peer, payload: bytes) -> None:
        from .compact import BlockTransactions
        from ..consensus.serialize import ByteReader

        try:
            bt = BlockTransactions.deserialize(ByteReader(payload))
        except Exception:
            raise NetMessageError("bad blocktxn") from None
        if peer.pending_cmpct is None:
            return  # unsolicited
        hsids, by_sid = peer.pending_cmpct
        if hsids.header.get_hash() == bt.block_hash:
            # this reply answers OUR getblocktxn — solicited bytes are
            # exempt from the flood ceiling (the reconstructed hash is
            # usually not in _requested_blocks, so _note_block_arrival's
            # solicited-exemption would not recognize it). Only the
            # MATCHING reply is exempt: a stream of mismatched "stale"
            # replies is attacker-chosen traffic and must keep counting,
            # or one dangling getblocktxn would neuter -maxrecvrate.
            peer.recv_window = max(0, peer.recv_window
                                   - (HEADER_SIZE + len(payload)))
        else:
            # stale reply for an overwritten reconstruction: fetch in
            # full — but ONLY a hash this peer actually announced (it is
            # attacker-controlled: registering an arbitrary 32-byte hash
            # in the download tracker would poison it with a block nobody
            # can ever deliver)
            if peer.id in self._block_sources.get(bt.block_hash, ()):
                self._request_or_park(peer, [bt.block_hash])
            return
        peer.pending_cmpct = None
        # retry reconstruction with the cached map + the supplied txs; the
        # shortid check inside reconstruct() rejects wrong fills
        from .compact import short_id, short_id_keys

        k0, k1 = short_id_keys(hsids.header, hsids.nonce)
        for tx in bt.txs:
            by_sid[short_id(k0, k1, tx.txid)] = tx
        block, missing = hsids.reconstruct(by_sid.get)
        if block is None:
            # reconstruction failed — fall back to a full block fetch,
            # through _request_blocks so the stall detector tracks it and
            # the delivered bytes count as solicited
            h = hsids.header.get_hash()
            self._request_or_park(peer, [h])
            return
        # wire_bytes=0: the flood exemption already happened above
        self._note_block_arrival(peer, block.get_hash())
        self._process_block_obj(peer, block)

    def _process_block_obj(self, peer: Peer, block: CBlock) -> None:
        """Shared block-acceptance tail for block/cmpctblock/blocktxn."""
        h = block.get_hash()
        peer.known_invs.add(h)
        with self.node.cs_main:
            # tip-relay serving (serving/sigservice): a reconstructed
            # block's non-mempool transactions get their sigchecks settled
            # through the shared service lanes first, so the connect below
            # probes them out of the sigcache instead of verifying inline.
            # Advisory only — prewarm gates itself (tip extension, live
            # mempool, REAL header PoW, merkle commitment) so garbage
            # bodies never buy interpreter time, and the connect stays
            # the authoritative verdict either way.
            if getattr(self.node, "sigservice", None) is not None:
                from ..serving import prewarm_block_sigs

                prewarm_block_sigs(self.node, block)
            try:
                # P2P block flow rides the pipelined engine (ISSUE 9):
                # competing tips speculatively connect as tree branches
                # (batches sharing the cross-block LanePacker) and the
                # live settle policy externalizes eagerly except inside
                # the -spechold fork-race grace window; with depth<=1
                # process_new_block_pipelined IS the serial engine
                cs = self.node.chainstate
                pipelined = getattr(cs, "process_new_block_pipelined",
                                    None)
                if pipelined is not None:
                    pipelined(block)
                    cs.settle_live()
                else:  # harness stubs pass a bare chainstate namespace
                    cs.process_new_block(block)
                self._block_sources.pop(h, None)  # landed — tracking done
            except BlockValidationError as e:
                if e.reason == "duplicate":
                    self._block_sources.pop(h, None)
                if e.reason not in ("duplicate", "prev-blk-not-found"):
                    log_print("net", "peer=%d sent invalid block %s: %s",
                              peer.id, hash_to_hex(h)[:16], e.reason)
                    self._send_reject(peer, "block", REJECT_INVALID,
                                      e.reason, h)
                    # a consensus-invalid block is an immediate discharge
                    # (net_processing.cpp Misbehaving(100)) — EXCEPT
                    # clock-subjective rejections: time-too-new is as
                    # likely our skewed clock as their bad block (the
                    # reference exempts BLOCK_TIME_FUTURE), and charging
                    # it would let a lagging local clock evict every
                    # honest relayer of the real tip one by one
                    if e.reason != "time-too-new":
                        self.misbehaving(peer, self.ban_threshold,
                                         "invalid-block")
                        # the DELIVERY was bad, but the block the header
                        # committed to may still be the honest chain's
                        # (e.g. a poisoned peer replayed a wanted hash
                        # with garbage txs — merkle mismatch). The
                        # arrival already untracked the download, so if
                        # the node still wants the hash (header accepted,
                        # no data, not marked failed — connect-time
                        # failures mark FAILED and never raise to here),
                        # park it for re-request from a healthy peer;
                        # otherwise one poisoned delivery per hash wedges
                        # IBD permanently. The deliverer is discharged
                        # above, so _tick never hands the hash back to it.
                        idx = self.node.chainstate.block_index.get(h)
                        if (idx is not None
                                and not (idx.status & BlockStatus.HAVE_DATA)
                                and not (idx.status
                                         & BlockStatus.FAILED_MASK)):
                            self._unrequested.add(h)

    # -- relay ----------------------------------------------------------

    def _on_tip_changed(self, tip) -> None:
        if tip is None:
            return
        header = tip.header

        def _announce():
            # runs on the event loop: peer-dict iteration is single-threaded
            # here, and the compact form is serialized lazily at most once
            cmpct_payload = None
            for peer in list(self.peers.values()):
                if not peer.handshaked or tip.hash in peer.known_invs:
                    continue
                peer.known_invs.add(tip.hash)
                try:
                    if peer.cmpct_announce:
                        if cmpct_payload is None:
                            with self.node.cs_main:
                                raw = self.node.block_store.get_block(tip.hash)
                            if raw is not None:
                                from .compact import HeaderAndShortIDs

                                cmpct_payload = HeaderAndShortIDs.from_block(
                                    CBlock.from_bytes(raw)).serialize()
                        if cmpct_payload is not None:
                            peer.send("cmpctblock", cmpct_payload)
                            continue
                    if peer.prefers_headers:  # BIP130 headers announce
                        peer.send("headers", ser_headers([header]))
                    else:
                        peer.send("inv", ser_inv([(MSG_BLOCK, tip.hash)]))
                except Exception:
                    pass
        if self.loop is not None:
            self.loop.call_soon_threadsafe(_announce)

    def _broadcast_inv(self, inv_type: int, h: bytes, skip_peer: int = 0) -> None:
        # tx relay honors BIP37: a peer with a loaded bloom filter only
        # hears about relevant txs; version.relay=False without a filter
        # suppresses tx invs entirely (net_processing.cpp SendMessages)
        tx = None
        fee_rate = 0
        if inv_type == MSG_TX:
            with self.node.cs_main:
                entry = self.node.mempool.get(h)
                if entry is not None:
                    tx = entry.tx
                    fee_rate = entry.fee * 1000 // max(entry.size, 1)
                    # mapRelay: remember for serving getdata post-mining
                    self._relay_memory[h] = (
                        tx, time.time() + RELAY_TX_CACHE_TIME)

        def _want(peer: Peer) -> bool:
            if inv_type != MSG_TX:
                return True
            if peer.min_fee_filter and fee_rate < peer.min_fee_filter:
                return False  # BIP133
            if peer.bloom_filter is not None:
                return tx is not None and \
                    peer.bloom_filter.is_relevant_and_update(tx)
            return peer.relay_txs

        def _do():
            for peer in self.peers.values():
                if peer.id == skip_peer or not peer.handshaked:
                    continue
                if h in peer.known_invs or not _want(peer):
                    continue
                peer.known_invs.add(h)
                try:
                    peer.send("inv", ser_inv([(inv_type, h)]))
                except Exception:
                    pass
        self.loop.call_soon_threadsafe(_do)

    def relay_block(self, h: bytes, skip_peer: int = 0) -> None:
        self._broadcast_inv(MSG_BLOCK, h, skip_peer)

    def relay_tx(self, h: bytes, skip_peer: int = 0) -> None:
        self._broadcast_inv(MSG_TX, h, skip_peer)
