"""Read-replica pool for the fleet serving front door (ISSUE 16).

A replica is an ordinary bcpd process bootstrapped in seconds from a
validator-produced UTXO snapshot (``dumptxoutset`` -> ``loadtxoutset``,
the PR 12 assumeutxo path) and kept at the tip over the existing
compact-block relay. This module owns the *robustness* half of the
story: per-replica health probes, a per-replica circuit breaker reusing
the ops/dispatch discipline (trip on consecutive transport failures,
half-open probes after a cooldown, re-admit on probe success), and the
consistency gate — a replica whose probed tip lags the pool fan-out
height by more than ``max_lag`` is rotated OUT and never served from,
so no reply externalizes state older than the bounded-staleness
contract promises.

Transport is an injectable callable ``(method, params) -> result`` so
the unit suite exercises every rotation/breaker/lag policy without a
single subprocess; the node wires in a thin JSON-RPC HTTP transport
(rpc/client idiom) against real replica processes. Every replica call
passes the ``replica_rpc`` fault site (util/faults.REPLICA_RPC_SITE,
explicit-only) so drills can kill or slow the replica leg on demand.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Callable, Optional, Sequence

from ..ops.dispatch import BreakerConfig, CircuitBreaker
from ..util import telemetry as tm
from ..util.faults import INJECTOR, REPLICA_RPC_SITE
from ..util.log import log_print

_PROBE_C = tm.counter(
    "bcp_gateway_replica_probes_total",
    "Replica health probes by outcome",
    labels=("replica", "outcome"))


class ReplicaError(RuntimeError):
    """Transport-level failure on the replica leg (socket error, timeout,
    malformed reply, injected fault). Method-level JSON-RPC errors are
    NOT wrapped here — they are definitive answers, not replica
    sickness, and must never trigger failover."""


class ReplicaRPCError(RuntimeError):
    """A definitive JSON-RPC error returned by a healthy replica (e.g.
    "Block not found"). Carries the error object so the gateway can
    relay it verbatim instead of failing over."""

    def __init__(self, error: dict):
        super().__init__(str(error.get("message", error)))
        self.error = dict(error)


def http_transport(host: str, port: int, auth_b64: str,
                   timeout: float = 30.0) -> Callable:
    """JSON-RPC-over-HTTP transport to one replica (rpc/client.py shape,
    per-call connection). Raises ReplicaError on any transport failure
    and ReplicaRPCError on a method-level error object."""

    def call(method: str, params: Sequence):
        payload = json.dumps({"jsonrpc": "1.0", "id": 0, "method": method,
                              "params": list(params)})
        try:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            try:
                conn.request("POST", "/", payload, {
                    "Authorization": f"Basic {auth_b64}",
                    "Content-Type": "application/json",
                })
                body = json.loads(conn.getresponse().read())
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException) as e:
            raise ReplicaError(f"{host}:{port}: {e!r}") from e
        if not isinstance(body, dict):
            raise ReplicaError(f"{host}:{port}: malformed reply")
        if body.get("error"):
            raise ReplicaRPCError(body["error"])
        return body.get("result")

    return call


class Replica:
    """One pool member: a transport, a breaker, and the last probed tip.

    ``in_rotation`` is the pool's serve/don't-serve verdict, refreshed on
    every probe pass: the breaker must be healthy AND the probed tip must
    be within ``max_lag`` of the pool fan-out height."""

    def __init__(self, name: str, transport: Callable,
                 breaker_cfg: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.name = name
        self.transport = transport
        self.breaker = CircuitBreaker(f"replica:{name}", cfg=breaker_cfg,
                                      clock=clock)
        self.tip_height = -1
        self.tip_hash = ""
        self.lagging = False
        # quarantine (ISSUE 17): the replica onboarded from a snapshot
        # whose trust is not yet established — no verified certificate at
        # load AND background validation still running. Pool-visible (it
        # probes, its tip feeds the fan-out height) but shed from serving
        # exactly like a lagging replica, until the probe sees
        # snapshot.certificate_verified flip true.
        self.quarantined = False
        self.quarantine_logged = False
        self.in_rotation = False
        self.last_probe_ok = 0.0
        # call/error tallies are bumped from every gateway handler
        # thread plus the probe loop; += is a read-modify-write tear
        # without this (BCP008)
        self._stats_lock = threading.Lock()
        self.calls = 0
        self.errors = 0

    def call(self, method: str, params: Sequence):
        """One serving call on the replica leg. Transport failures (and
        injected ``replica_rpc`` faults) count against the breaker at the
        CALLER — the gateway records the verdict so a coalesced leader's
        failure is charged exactly once."""
        INJECTOR.on_call(REPLICA_RPC_SITE)
        with self._stats_lock:
            self.calls += 1
        try:
            return self.transport(method, params)
        except ReplicaRPCError:
            raise  # definitive answer — not replica sickness
        except Exception as e:
            with self._stats_lock:
                self.errors += 1
            raise ReplicaError(f"replica {self.name}: {e!r}") from e

    def probe(self) -> bool:
        """Health probe: one getblockchaininfo through the same injected
        leg as serving traffic (a replica that can't serve probes can't
        serve reads either). Updates the probed tip and the breaker."""
        try:
            info = self.call("getblockchaininfo", [])
            self.tip_height = int(info["blocks"])
            self.tip_hash = str(info["bestblockhash"])
            # absent sub-doc = never snapshot-onboarded = nothing to
            # quarantine; present = trust the gate it reports
            snap = info.get("snapshot")
            self.quarantined = bool(
                snap and not snap.get("certificate_verified"))
        except Exception as e:
            self.breaker.record_failure(e)
            _PROBE_C.labels(replica=self.name, outcome="fail").inc()
            return False
        self.breaker.record_success()
        self.last_probe_ok = time.monotonic()
        _PROBE_C.labels(replica=self.name, outcome="ok").inc()
        return True

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "in_rotation": self.in_rotation,
            "lagging": self.lagging,
            "quarantined": self.quarantined,
            "tip_height": self.tip_height,
            "tip_hash": self.tip_hash,
            "calls": self.calls,
            "errors": self.errors,
            "breaker": self.breaker.snapshot(),
        }


class ReplicaPool:
    """Health-probed, breaker-gated, lag-gated rotation over N replicas.

    ``probe_once()`` is the single source of truth for rotation: it
    probes every replica whose breaker admits a call (OPEN breakers wait
    out their cooldown — the probabilistic half-open probe IS the
    re-admission test), computes the fan-out height as the max of the
    validator tip and every replica tip, and rotates out any replica
    lagging it by more than ``max_lag``. A background thread runs the
    pass every ``probe_interval`` seconds; tests call it directly."""

    def __init__(self, replicas: Sequence[Replica], max_lag: int = 2,
                 probe_interval: float = 0.5,
                 validator_tip: Optional[Callable[[], int]] = None):
        self.replicas = list(replicas)
        self.max_lag = max(0, int(max_lag))
        self.probe_interval = probe_interval
        self.validator_tip = validator_tip
        self.fanout_height = -1
        self.rotations_out = 0     # times a replica left the rotation
        self.quarantines = 0       # rotations-out caused by quarantine
        self._rr = 0               # round-robin cursor
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- probing --------------------------------------------------------

    def probe_once(self) -> None:
        heights = []
        if self.validator_tip is not None:
            try:
                heights.append(int(self.validator_tip()))
            except Exception:
                pass
        for rep in self.replicas:
            if rep.breaker.allow():
                if rep.probe():
                    heights.append(rep.tip_height)
            elif rep.tip_height >= 0:
                heights.append(rep.tip_height)
        self.fanout_height = max(heights) if heights else -1
        for rep in self.replicas:
            rep.lagging = (rep.tip_height < 0 or
                           self.fanout_height - rep.tip_height > self.max_lag)
            admit = (rep.breaker.healthy() and not rep.lagging
                     and not rep.quarantined)
            if rep.in_rotation and not admit:
                self.rotations_out += 1
                log_print("gateway", "replica %s rotated out (lagging=%s "
                          "quarantined=%s breaker=%s tip=%d fanout=%d)",
                          rep.name, rep.lagging, rep.quarantined,
                          rep.breaker.state, rep.tip_height,
                          self.fanout_height)
            elif not rep.in_rotation and admit and rep.quarantine_logged:
                log_print("gateway", "replica %s re-admitted (certificate "
                          "verified, tip=%d)", rep.name, rep.tip_height)
            if rep.quarantined and not rep.quarantine_logged:
                # one per episode, whether the replica was shed from
                # rotation or arrived already-quarantined (a fresh
                # cert-less onboard is an episode too)
                rep.quarantine_logged = True
                self.quarantines += 1
                log_print("gateway", "replica %s QUARANTINED: snapshot "
                          "loaded without verified certificate — shed "
                          "from serving until validation completes",
                          rep.name)
            elif not rep.quarantined:
                rep.quarantine_logged = False
            rep.in_rotation = admit

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            try:
                self.probe_once()
            except Exception:  # the prober itself must not die
                pass

    def start(self) -> None:
        if self._thread is None:
            self.probe_once()
            self._thread = threading.Thread(
                target=self._probe_loop, name="replica-probe", daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- selection ------------------------------------------------------

    def pick(self, exclude: Sequence[str] = ()) -> Optional[Replica]:
        """Next in-rotation replica (round-robin), skipping ``exclude``
        (names already tried this request — the failover loop's memory)
        and any replica whose breaker refuses the call right now."""
        if not self.replicas:
            return None
        with self._lock:
            start = self._rr
            for i in range(len(self.replicas)):
                rep = self.replicas[(start + i) % len(self.replicas)]
                if rep.name in exclude or not rep.in_rotation:
                    continue
                if not rep.breaker.allow():
                    continue
                self._rr = (start + i + 1) % len(self.replicas)
                return rep
        return None

    def in_rotation(self) -> list[Replica]:
        return [r for r in self.replicas if r.in_rotation]

    def snapshot(self) -> dict:
        return {
            "fanout_height": self.fanout_height,
            "max_lag": self.max_lag,
            "rotations_out": self.rotations_out,
            "quarantines": self.quarantines,
            "quarantined": sum(1 for r in self.replicas if r.quarantined),
            "replicas": [r.snapshot() for r in self.replicas],
        }
