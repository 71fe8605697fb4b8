"""Fleet serving front door (ISSUE 16): admission, coalescing, failover.

The gateway is a JSON-RPC HTTP server (rpc/server shape) that fronts one
validator and N read replicas (serving/replicas.ReplicaPool):

* **Admission** — per-client token buckets with *graduated* shedding:
  a read-only query must leave a reserve of its client's bucket for
  tip-critical traffic (submit/send/template), and the global in-flight
  ceiling sheds read-only at the soft limit long before tip-critical
  hits the hard limit. Every reject is a metered, 429-style JSON-RPC
  error (``GATEWAY_OVERLOADED``) — never a silent drop.
* **Coalescing** — identical in-flight ``getblock``/``gettxout``/
  ``getblocktemplate``-class queries collapse to ONE backend call via
  the SigService dedup pattern (in-flight table keyed by method+params,
  followers rendezvous on the leader's condvar).
* **Failover** — read queries round-robin over the replica rotation;
  a transport failure records against that replica's breaker and the
  *idempotent* read retries on the next healthy replica after a
  jittered ``util/faults.Backoff`` pause, falling back to the validator
  when the rotation is exhausted. Method-level RPC errors are
  definitive answers and relay verbatim (no failover).
* **Consistency gate** — the gateway only ever picks replicas the pool
  keeps in rotation, and the pool rotates out anything lagging the
  fan-out height beyond ``-maxreplicalag`` (replicas.ReplicaPool).

Fault site ``gateway`` (util/faults.GATEWAY_SITE, explicit-only) fires
at the admission boundary; ``replica_rpc`` fires on every replica leg
(serving/replicas.Replica.call).

Telemetry: native ``bcp_gateway_*`` families below plus a registry
collector projecting per-replica breaker state — unregistered in
``close()`` so a test-scoped gateway never leaks into later scrapes.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

from ..util import telemetry as tm
from ..util.faults import GATEWAY_SITE, INJECTOR, Backoff
from ..util.log import log_print, log_printf
from .replicas import ReplicaPool, ReplicaRPCError

# 429-style JSON-RPC reject (the HTTP layer also sets status 429)
GATEWAY_OVERLOADED = -429

# Read-only queries a bounded-staleness replica may answer. Mempool views
# are deliberately absent: replica mempools are independent, so anything
# mempool-shaped stays on the validator.
READ_METHODS = frozenset({
    "getblock", "getblockhash", "getblockcount", "getbestblockhash",
    "getblockheader", "getblockchaininfo", "gettxout", "gettxoutsetinfo",
    "getdifficulty", "getchaintips", "getblockstats",
})

# Identical in-flight queries that collapse to one backend call.
# getblocktemplate is validator-bound but the most expensive read on the
# box — exactly the call a thundering herd of miners duplicates.
COALESCE_METHODS = READ_METHODS | {"getblocktemplate"}

_ADMIT_C = tm.counter(
    "bcp_gateway_admitted_total",
    "Requests admitted past the gateway's token-bucket/overload gates",
    labels=("cls",))
_SHED_C = tm.counter(
    "bcp_gateway_sheds_total",
    "Requests shed (429-style reject) by traffic class and reason "
    "(rate = client token bucket, overload = global in-flight ceiling)",
    labels=("cls", "reason"))
_COAL_C = tm.counter(
    "bcp_gateway_coalesce_hits_total",
    "Requests served as followers of an identical in-flight query "
    "(one backend call fanned out to N clients)")
_FAIL_C = tm.counter(
    "bcp_gateway_failovers_total",
    "Mid-request failovers: a replica leg failed and the idempotent "
    "read retried on another backend")
_VFB_C = tm.counter(
    "bcp_gateway_validator_fallback_total",
    "Read queries served by the validator because the replica rotation "
    "was empty or exhausted")
_LAT_H = tm.histogram(
    "bcp_gateway_latency_seconds",
    "Gateway request latency by traffic class (admission to reply)",
    labels=("cls",))

_BREAKER_STATE_NUM = {"closed": 0, "half-open": 1, "open": 2}


class GatewayReject(RuntimeError):
    """Admission reject — maps to a 429-style JSON-RPC error."""

    def __init__(self, message: str):
        super().__init__(message)
        self.code = GATEWAY_OVERLOADED


class BackendRPCError(RuntimeError):
    """Definitive JSON-RPC error from a backend — relayed verbatim."""

    def __init__(self, error: dict):
        super().__init__(str(error.get("message", error)))
        self.error = dict(error)


class TokenBucket:
    """Classic token bucket with a *floor*: ``take(n, floor=f)`` refuses
    to spend below ``f`` tokens — how read-only traffic is made to leave
    a reserve for tip-critical calls from the same client."""

    __slots__ = ("capacity", "rate", "tokens", "stamp")

    def __init__(self, capacity: float, rate: float, now: float):
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.tokens = float(capacity)
        self.stamp = now

    def take(self, n: float, floor: float, now: float) -> bool:
        if now > self.stamp:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now
        if self.tokens - n >= floor:
            self.tokens -= n
            return True
        return False


class _Flight:
    """One in-flight coalesced query (SigService _Lane shape): the leader
    executes, followers wait on the condvar and share the settled result
    or exception."""

    __slots__ = ("cv", "done", "result", "error", "followers")

    def __init__(self, lock: threading.Lock):
        self.cv = threading.Condition(lock)
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.followers = 0


class Coalescer:
    """In-flight request dedup (the SigService ``_by_key`` pattern)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_key: dict[str, _Flight] = {}

    def run(self, key: str, fn: Callable) -> tuple[object, bool]:
        """Execute ``fn`` once per distinct in-flight ``key``; returns
        ``(result, follower)`` where follower=True means this call rode
        an identical leader's backend call."""
        with self._lock:
            fl = self._by_key.get(key)
            if fl is None:
                fl = self._by_key[key] = _Flight(self._lock)
                leader = True
            else:
                fl.followers += 1
                leader = False
        if leader:
            try:
                fl.result = fn()
            except BaseException as e:
                fl.error = e
            finally:
                with self._lock:
                    fl.done = True
                    self._by_key.pop(key, None)
                    fl.cv.notify_all()
        else:
            with self._lock:
                while not fl.done:
                    fl.cv.wait()
        if fl.error is not None:
            raise fl.error
        return fl.result, not leader


class Gateway:
    """The front door. ``backend`` is the validator call path (method,
    params) -> result, raising BackendRPCError for method-level errors;
    ``pool`` is the replica rotation. Construct + ``handle()`` directly
    in unit tests; ``start()`` binds the HTTP server for real fleets."""

    MAX_CLIENTS = 4096  # bounded LRU of per-client token buckets

    def __init__(self, backend: Callable, pool: ReplicaPool,
                 rate: float = 500.0, burst: float = 200.0,
                 read_reserve: float = 0.25,
                 soft_inflight: int = 64, hard_inflight: int = 256,
                 bind: str = "127.0.0.1", port: int = 0,
                 auth_b64: str = "", clock=time.monotonic,
                 backoff_base: float = 0.01, backoff_max: float = 0.2):
        self.backend = backend
        self.pool = pool
        self.rate = float(rate)
        self.burst = float(burst)
        self.read_reserve = float(read_reserve)
        self.soft_inflight = int(soft_inflight)
        self.hard_inflight = int(hard_inflight)
        self._bind, self._port_req = bind, port
        self._auth = auth_b64
        self._clock = clock
        self._backoff_base, self._backoff_max = backoff_base, backoff_max
        self._coalescer = Coalescer()
        self._adm_lock = threading.Lock()
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._inflight = 0
        self._stats_lock = threading.Lock()
        self.stats = {
            "admitted": {"read": 0, "tip": 0},
            "sheds": {"read": 0, "tip": 0},
            "coalesce_hits": 0,
            "failovers": 0,
            "validator_fallback": 0,
            "requests": 0,
        }
        self._httpd = None
        self._thread = None
        self.port = 0
        self._collector_name = f"gateway:{id(self):x}"
        tm.register_collector(self._collector_name, self._collect)

    # -- telemetry ------------------------------------------------------

    def _collect(self):
        """Scrape-time projection of the replica rotation: breaker state,
        probed tip, and in-rotation flag per replica. Family names are
        disjoint from the native bcp_gateway_* counters above (BCP001)."""
        state = {"name": "bcp_gateway_replica_state", "type": "gauge",
                 "help": "Replica breaker state "
                         "(0=closed 1=half-open 2=open)", "samples": []}
        rot = {"name": "bcp_gateway_replica_in_rotation", "type": "gauge",
               "help": "1 when the replica is served from", "samples": []}
        tip = {"name": "bcp_gateway_replica_tip_height", "type": "gauge",
               "help": "Last probed replica tip height", "samples": []}
        quar = {"name": "bcp_gateway_replica_quarantined", "type": "gauge",
                "help": "1 while the replica is shed for serving an "
                        "unverified snapshot (certificate quarantine)",
                "samples": []}
        infl = {"name": "bcp_gateway_inflight", "type": "gauge",
                "help": "Requests currently inside the gateway",
                "samples": [({}, self._inflight)]}
        for rep in self.pool.replicas:
            lbl = {"replica": rep.name}
            state["samples"].append(
                (lbl, _BREAKER_STATE_NUM.get(rep.breaker.state, -1)))
            rot["samples"].append((lbl, 1 if rep.in_rotation else 0))
            tip["samples"].append((lbl, rep.tip_height))
            quar["samples"].append((lbl, 1 if rep.quarantined else 0))
        return [state, rot, tip, quar, infl]

    # -- admission ------------------------------------------------------

    def _bucket_for(self, client: str, now: float) -> TokenBucket:
        b = self._buckets.get(client)
        if b is None:
            b = self._buckets[client] = TokenBucket(self.burst, self.rate,
                                                    now)
            while len(self._buckets) > self.MAX_CLIENTS:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(client)
        return b

    def _admit(self, cls: str, client: str) -> None:
        """Token-bucket + overload gate; raises GatewayReject on shed.
        Graduated: read-only sheds at the soft in-flight ceiling and
        must leave ``read_reserve`` of its bucket; tip-critical runs to
        the hard ceiling and may drain its bucket to zero."""
        now = self._clock()
        with self._adm_lock:
            ceiling = (self.soft_inflight if cls == "read"
                       else self.hard_inflight)
            if self._inflight >= ceiling:
                self._shed(cls, "overload")
            floor = self.burst * self.read_reserve if cls == "read" else 0.0
            if not self._bucket_for(client, now).take(1.0, floor, now):
                self._shed(cls, "rate")
            self._inflight += 1
        _ADMIT_C.labels(cls=cls).inc()
        with self._stats_lock:
            self.stats["admitted"][cls] += 1

    def _shed(self, cls: str, reason: str) -> None:
        _SHED_C.labels(cls=cls, reason=reason).inc()
        with self._stats_lock:
            self.stats["sheds"][cls] += 1
        raise GatewayReject(
            f"gateway overloaded — request shed (class={cls}, "
            f"reason={reason}); retry with backoff")

    # -- serving --------------------------------------------------------

    def handle(self, method: str, params: Sequence, client: str = ""):
        """One admitted-or-shed request, start to finish. Raises
        GatewayReject (shed), BackendRPCError (definitive RPC error) or
        propagates transport/injected failures after every failover and
        the validator fallback are exhausted."""
        t0 = time.monotonic()
        cls = "read" if method in READ_METHODS else "tip"
        INJECTOR.on_call(GATEWAY_SITE)
        self._admit(cls, client)
        try:
            with self._stats_lock:
                self.stats["requests"] += 1
            if method in COALESCE_METHODS:
                key = method + ":" + json.dumps(
                    list(params), sort_keys=True, default=str)
                result, follower = self._coalescer.run(
                    key, lambda: self._dispatch(method, params, cls))
                if follower:
                    _COAL_C.inc()
                    with self._stats_lock:
                        self.stats["coalesce_hits"] += 1
                return result
            return self._dispatch(method, params, cls)
        finally:
            with self._adm_lock:
                self._inflight -= 1
            _LAT_H.labels(cls=cls).observe(time.monotonic() - t0)

    def _dispatch(self, method: str, params: Sequence, cls: str):
        if cls == "read":
            return self._serve_read(method, params)
        return self.backend(method, params)

    def _serve_read(self, method: str, params: Sequence):
        """Replica rotation with mid-request failover. Reads are
        idempotent by construction (READ_METHODS), so retrying the same
        query on another replica is always safe."""
        tried: list[str] = []
        boff = Backoff(base=self._backoff_base, maximum=self._backoff_max)
        last: Optional[BaseException] = None
        for _ in range(len(self.pool.replicas)):
            rep = self.pool.pick(exclude=tried)
            if rep is None:
                break
            try:
                result = rep.call(method, params)
            except ReplicaRPCError as e:
                # the replica ANSWERED — an RPC-level error is a healthy
                # reply, relayed verbatim, never failed over
                rep.breaker.record_success()
                raise BackendRPCError(e.error) from e
            except Exception as e:
                rep.breaker.record_failure(e)
                tried.append(rep.name)
                last = e
                _FAIL_C.inc()
                with self._stats_lock:
                    self.stats["failovers"] += 1
                log_print("gateway", "read %s failed on replica %s (%r) — "
                          "failing over", method, rep.name, e)
                time.sleep(boff.next())
                continue
            rep.breaker.record_success()
            return result
        # rotation empty or exhausted: the validator serves the read
        _VFB_C.inc()
        with self._stats_lock:
            self.stats["validator_fallback"] += 1
        if last is not None:
            log_print("gateway", "read %s: rotation exhausted — validator "
                      "fallback", method)
        return self.backend(method, params)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Bind the HTTP front door and start the pool's probe loop."""
        from http.server import ThreadingHTTPServer

        self.pool.start()
        self._httpd = ThreadingHTTPServer(
            (self._bind, self._port_req), _make_handler(self))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway", daemon=True)
        self._thread.start()
        log_printf("Gateway listening on %s:%d (%d replicas)",
                   self._bind, self.port, len(self.pool.replicas))

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.pool.close()
        # the PR 6 lesson: a scrape after close must not see this gateway
        tm.REGISTRY.unregister_collector(self._collector_name)

    def snapshot(self) -> dict:
        with self._stats_lock:
            stats = json.loads(json.dumps(self.stats))
        return {
            **stats,
            "inflight": self._inflight,
            "port": self.port,
            "pool": self.pool.snapshot(),
        }

    # -- HTTP request execution ----------------------------------------

    def execute(self, request: dict, client: str) -> dict:
        """One JSON-RPC call object to one response object (RPCServer
        .execute shape, with the gateway's admission/failover wrapped
        around the dispatch)."""
        req_id = request.get("id")
        method = request.get("method")
        params = request.get("params") or []
        if not isinstance(method, str) or not isinstance(params, list):
            return _error_obj(req_id, -32600, "Invalid Request")
        try:
            result = self.handle(method, params, client)
        except GatewayReject as e:
            return _error_obj(req_id, e.code, str(e))
        except BackendRPCError as e:
            return {"result": None, "error": e.error, "id": req_id}
        except Exception as e:
            log_printf("gateway internal error in %s: %r", method, e)
            return _error_obj(req_id, -32603, f"gateway error: {e}")
        return {"result": result, "error": None, "id": req_id}


def _error_obj(req_id, code: int, message: str) -> dict:
    return {"result": None,
            "error": {"code": code, "message": message}, "id": req_id}


def _make_handler(gw: Gateway):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log_print("gateway", "http: " + fmt, *args)

        def _reply(self, status: int, payload: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if gw._auth and \
                    self.headers.get("Authorization") != f"Basic {gw._auth}":
                self.send_response(401)
                self.send_header("WWW-Authenticate",
                                 'Basic realm="gateway"')
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            client = self.headers.get("X-Client-Id") \
                or self.client_address[0]
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length))
            except (ValueError, json.JSONDecodeError):
                self._reply(500, json.dumps(
                    _error_obj(None, -32700, "Parse error")).encode())
                return
            if isinstance(body, list):
                response = [gw.execute(req, client) for req in body]
                status = 200
            else:
                response = gw.execute(body, client)
                err = response.get("error")
                status = 429 if err \
                    and err["code"] == GATEWAY_OVERLOADED else 200
            self._reply(status, json.dumps(response).encode())

    return Handler
