"""Fault-injection harness, jittered backoff, and crash points.

The accelerator graft puts both consensus-critical hot paths (SHA-256d and
batch ECDSA) behind a device boundary; hardware-miner practice (AsicBoost,
arXiv:1604.00575; FPGA miners, arXiv:2212.05033) treats device failure as an
expected operating mode with host fallback, not an exception. This module is
the failure-side toolkit shared by the supervised dispatch layer
(ops/dispatch.py), the crash-safe chainstate commit (store/), and P2P
reconnect pacing (p2p/connman.py):

  - ``FaultInjector`` — deterministic, env-driven fault injection at every
    backend-crossing call site, so tests can kill the TPU path anywhere:
        BCP_FAULT_MODE   off | fail-once | fail-n | fail-always | fail-rate
                         | latency-spike | poison-output
        BCP_FAULT_OPS    comma list of sites ("sha256,ecdsa") or "all"
        BCP_FAULT_N      failure count for fail-n (default 1)
        BCP_FAULT_RATE   failure probability for fail-rate (default 0.5)
        BCP_FAULT_SEED   rng seed for fail-rate (default 0 — deterministic)
        BCP_FAULT_LATENCY_MS  sleep per call for latency-spike (default 50)
  - ``maybe_crash`` — hard-kill crash points (BCP_FAULT_CRASH=<point>) used
    by the chainstate-commit journal tests: os._exit, no atexit, no sqlite
    rollback — a genuine mid-commit death.
  - ``Backoff`` — jittered exponential backoff (full-jitter variant) used by
    dispatch retries and the connection manager's dial loop.
  - ``ChaosSchedule`` — deterministic, seeded planner of adversarial network
    actions (flood bursts, non-connecting headers, stalls, scripted
    disconnects) driving the functional ``ChaosPeer`` harness and the
    ``net`` injection site below.

Network fault site: ``BCP_FAULT_OPS=net`` arms the injector at the P2P
message-dispatch boundary (p2p/connman.py) — ``fail-rate`` then models
message loss, ``latency-spike`` a slow link. The ``net`` site is only armed
when named explicitly; ``BCP_FAULT_OPS=all`` still means the accelerator
subsystems only, so existing dead-backend drills are unchanged.

Everything here is stdlib-only so every layer can import it without cycles
(and the crash-test worker subprocess stays jax-free).
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional

# The four supervised accelerator subsystems (ops/dispatch.py breakers).
SITES = ("sha256", "merkle", "miner", "ecdsa")

# The P2P message-dispatch injection site (explicit opt-in only — never
# part of the "all" set, see module docstring).
NET_SITE = "net"
# "ecdsa_glv" (ops/ecdsa_batch.GLV_SITE) is likewise explicit-only: it
# targets the GLV kernel LEG inside the ecdsa dispatch so drills can prove
# the glv -> w4 -> CPU degradation chain without disturbing the
# whole-subsystem "ecdsa" site the dead-backend suite arms via "all".
# "ecdsa_glv_dev" (ops/ecdsa_batch.GLV_DEV_SITE) targets the
# device-decompose leg specifically (ISSUE 11): fail-* proves the
# device-decompose -> host-decompose rung, poison-output proves the KAT
# gate; also explicit-only, for the same reason.
# "ecdsa_msm" (ops/ecdsa_batch.MSM_SITE) targets the Schnorr Pippenger
# batch-check leg (ISSUE 19): fail-* proves the bisect-to-oracle
# fallback rung, poison-output flips every batch verdict — canary
# batches included — proving the per-session canary gate catches a
# corrupted verdict stream; also explicit-only.
# "store_shard" (store/sharded.STORE_SHARD_SITE) fires at the head of
# every shard's journal leg inside a sharded chainstate commit: fail-*
# proves one failing shard aborts the WHOLE commit with the already-
# written journals unlinked (no shard ever ahead of the manifest epoch),
# latency-spike models one slow shard dragging the parallel flush.
# Explicit-only: "all" must keep meaning the accelerator subsystems so
# the dead-backend drills don't suddenly fail chainstate flushes.

# Fleet serving injection sites (ISSUE 16), both explicit-only for the
# same reason as "net": "all" keeps meaning the accelerator subsystems.
# GATEWAY_SITE fires at the gateway's admission/dispatch boundary —
# fail-* models a front-door hiccup the client sees as a retryable RPC
# error, latency-spike a slow front door (burns the admission budget,
# drives graduated shedding). REPLICA_RPC_SITE fires on the replica leg
# of every proxied read — fail-* models a dying replica (drives breaker
# trips and mid-request failover), latency-spike a GC-pausing one.
GATEWAY_SITE = "gateway"
REPLICA_RPC_SITE = "replica_rpc"

# Proof-carrying snapshot certificate site (ISSUE 17), explicit-only like
# the other non-accelerator sites. It fires on BOTH legs of the
# certificate lifecycle: at build (dumptxoutset) poison-output corrupts
# one mid-trajectory epoch digest BEFORE the commitment chain is sealed —
# the forged-epoch snapshot that passes structural verification at load
# and must be caught at the first divergent epoch checkpoint by the
# shadow validator; at verify (loadtxoutset) fail-* models a certificate
# check blowing up mid-load and must take the wipe-and-reject path, never
# a half-loaded chainstate.
SNAPSHOT_CERT_SITE = "snapshot_cert"

# Flood-scale mempool site (ISSUE 20), explicit-only like the other
# non-accelerator sites. It fires at the head of the batched legs of
# template selection (CTxMemPool.select_for_block) and bulk eviction
# (trim_to_size): fail-* proves the per-tx reference fallback rung
# (frontier/columns bypassed, answer unchanged), poison-output corrupts
# the batched verdict — a dropped template tail, a wrong eviction victim
# — and must be caught by the differential gate re-deriving the verdict
# through the per-tx oracle (the -mempoolselfcheck path, always-on under
# poison drills).
MEMPOOL_SITE = "mempool"


class InjectedFault(RuntimeError):
    """A deliberately injected device failure (never raised in production
    unless BCP_FAULT_MODE is armed)."""


class PoisonedOutput(RuntimeError):
    """Device output failed its host-side validation probe (known-answer
    lane / witness / spot-check) — the output must not be trusted."""


class FaultInjector:
    """Env-configured, per-site deterministic fault injection.

    Call counting is per site so fail-once/fail-n behave identically
    regardless of which subsystem fires first. ``reload()`` re-reads the
    environment — tests arm/disarm by setting BCP_FAULT_* and reloading.
    """

    def __init__(self):
        self.reload()

    def reload(self) -> None:
        self.mode = os.environ.get("BCP_FAULT_MODE", "off").strip().lower()
        ops = os.environ.get("BCP_FAULT_OPS", "all").strip().lower()
        self.sites = (
            set(SITES) if ops in ("", "all")
            else {s.strip() for s in ops.split(",") if s.strip()}
        )
        self.fail_n = int(os.environ.get("BCP_FAULT_N", "1"))
        self.rate = float(os.environ.get("BCP_FAULT_RATE", "0.5"))
        self.latency_s = (
            float(os.environ.get("BCP_FAULT_LATENCY_MS", "50")) / 1e3
        )
        self._rng = random.Random(int(os.environ.get("BCP_FAULT_SEED", "0")))
        self.crash_point = os.environ.get("BCP_FAULT_CRASH", "")
        self.calls: dict[str, int] = {}
        self.injected: dict[str, int] = {}
        self.poisoned: dict[str, int] = {}

    # -- call-site hooks ------------------------------------------------

    def armed_for(self, site: str) -> bool:
        return self.mode != "off" and site in self.sites

    def on_call(self, site: str) -> None:
        """Invoked by the supervised dispatcher immediately before each
        device attempt. May sleep (latency-spike) or raise InjectedFault."""
        if not self.armed_for(site):
            return
        n = self.calls.get(site, 0) + 1
        self.calls[site] = n
        fail = False
        if self.mode == "fail-once":
            fail = n == 1
        elif self.mode == "fail-n":
            fail = n <= self.fail_n
        elif self.mode == "fail-always":
            fail = True
        elif self.mode == "fail-rate":
            fail = self._rng.random() < self.rate
        elif self.mode == "latency-spike":
            time.sleep(self.latency_s)
        if fail:
            self.injected[site] = self.injected.get(site, 0) + 1
            raise InjectedFault(
                f"injected fault at {site} (mode={self.mode}, call #{n})"
            )

    def latency(self, site: str) -> float:
        """Latency-spike support for callers on an event loop: returns the
        sleep they must apply themselves (``await asyncio.sleep(...)``)
        instead of letting :meth:`on_call`'s blocking ``time.sleep`` stall
        the whole loop. Zero when the site isn't armed for latency-spike.
        Calls served this way are not tallied in ``calls``."""
        if self.armed_for(site) and self.mode == "latency-spike":
            return self.latency_s
        return 0.0

    def should_poison(self, site: str) -> bool:
        """True when the dispatcher must corrupt this call's device output
        (the validation probe is then expected to catch it)."""
        if self.mode != "poison-output" or site not in self.sites:
            return False
        self.poisoned[site] = self.poisoned.get(site, 0) + 1
        return True

    def snapshot(self) -> dict:
        return {
            "mode": self.mode,
            "sites": sorted(self.sites) if self.mode != "off" else [],
            "calls": dict(self.calls),
            "injected": dict(self.injected),
            "poisoned": dict(self.poisoned),
        }


INJECTOR = FaultInjector()


def maybe_crash(point: str) -> None:
    """Hard-kill the process at a named crash point when armed
    (BCP_FAULT_CRASH=<point>). os._exit skips atexit/finally/sqlite
    rollback — the honest simulation of a power cut mid-commit."""
    if INJECTOR.crash_point and INJECTOR.crash_point == point:
        os._exit(137)


class Backoff:
    """Jittered exponential backoff (full-jitter): delay_k is drawn
    uniformly from [(1-jitter)*d_k, d_k] with d_k = min(base*factor^k, max).
    ``reset()`` on success returns to the base delay. An injectable rng
    keeps tests deterministic."""

    def __init__(self, base: float = 0.5, factor: float = 2.0,
                 maximum: float = 30.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.factor = factor
        self.maximum = maximum
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random()
        self.attempts = 0

    def next(self) -> float:
        d = min(self.base * (self.factor ** self.attempts), self.maximum)
        self.attempts += 1
        return d * (1.0 - self.jitter * self._rng.random())

    def reset(self) -> None:
        self.attempts = 0


# The per-round action vocabulary drawn by a scheduled chaos peer
# (tests/functional/framework.ChaosPeer's "garbage" behavior; the flood
# and stall behaviors are continuous rather than action-scheduled).
CHAOS_ACTIONS = (
    "garbage-headers",  # valid-PoW headers on an unknown parent
    "ghost",            # stop talking, keep the socket open
    "reconnect",        # scripted disconnect + fresh session
)

# The fleet-level action vocabulary for multi-node fork-storm campaigns
# (tests/functional/test_fork_storm.py): the scheduler draws these to
# drive a whole topology — split the fleet, mine competing branches on
# both sides, heal and watch convergence. Seeded like everything else:
# one -netseed replays the identical storm.
FLEET_ACTIONS = (
    "mine",        # extend the majority side's chain
    "fork",        # mine a competing branch on a minority side
    "partition",   # split the fleet into two seeded halves
    "heal",        # reconnect the halves (the fork war resolves)
)


class ChaosSchedule:
    """Deterministic, seeded adversarial-action planner.

    One instance per chaos peer: every draw (next action, pause length,
    burst size, random bytes/hashes) comes from a single seeded rng, so a
    campaign is replayable from its seed alone — the property the
    randomized differential tests in this repo already rely on. The
    schedule records its history for post-mortem assertions."""

    def __init__(self, seed: int, actions: tuple = CHAOS_ACTIONS,
                 min_pause: float = 0.05, max_pause: float = 0.4):
        self.seed = seed
        self._rng = random.Random(seed)
        self.actions = tuple(actions)
        self.min_pause = min_pause
        self.max_pause = max_pause
        self.history: list[str] = []

    def next_action(self) -> str:
        action = self._rng.choice(self.actions)
        self.history.append(action)
        return action

    def pause(self) -> float:
        span = self.max_pause - self.min_pause
        return self.min_pause + span * self._rng.random()

    def burst_size(self, lo: int = 4, hi: int = 32) -> int:
        return self._rng.randint(lo, hi)

    def randbytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)

    def randhash(self) -> bytes:
        return self._rng.randbytes(32)

    def randint(self, lo: int, hi: int) -> int:
        return self._rng.randint(lo, hi)

    def shuffle(self, items: list) -> list:
        """In-place seeded shuffle (tx-storm delivery order); returns the
        list for chaining."""
        self._rng.shuffle(items)
        return items

    def rand(self) -> float:
        return self._rng.random()

    def choice(self, items):
        """Seeded pick from any sequence (fleet action targets)."""
        return self._rng.choice(items)

    def bipartition(self, n: int) -> tuple[list[int], list[int]]:
        """Seeded split of node indices 0..n-1 into two non-empty halves
        — the ``partition`` fleet action's topology draw. The cut point
        and the membership are both schedule-driven, so one seed replays
        the identical partition sequence."""
        idxs = list(range(n))
        self._rng.shuffle(idxs)
        cut = self._rng.randint(1, max(1, n - 1))
        return sorted(idxs[:cut]), sorted(idxs[cut:])


def retry_call(fn, attempts: int = 3, backoff: Optional[Backoff] = None,
               retry_on: tuple = (Exception,), sleep=time.sleep):
    """Call ``fn`` up to ``attempts`` times with backoff sleeps between
    tries; re-raises the last error when every attempt fails."""
    boff = backoff if backoff is not None else Backoff(base=0.02, maximum=1.0)
    last: Optional[BaseException] = None
    for i in range(max(1, attempts)):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            last = e
            if i + 1 < attempts:
                sleep(boff.next())
    assert last is not None
    raise last
