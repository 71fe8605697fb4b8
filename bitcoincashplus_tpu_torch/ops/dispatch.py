"""Supervised backend dispatch — circuit breakers over every device crossing.

Port of the reference's ops/dispatch.py; the breakers, backoff, fault
sites and supervised call/enqueue forms are unchanged. Every consensus-
relevant device call funnels through a per-subsystem circuit breaker:
bounded retries with jittered backoff absorb transient device errors; the
breaker opens after N consecutive hard failures and routes traffic to the
reference CPU engine; probabilistic half-open probes re-test the device.
The ecdsa site's known-answer lanes and reject-side host confirmation
live in ops/ecdsa_batch (BatchHandle).

The miner site (``supervised_sweep`` / ``supervised_resident_sweep``)
re-verifies every claimed nonce on the host. One difference from the
reference, deliberate: ``supervised_call`` serves ``cpu_fn`` only for a
fault the harness injected (``BCP_FAULT_*``: an ``InjectedFault``, or a
validation failure of output it poisoned), and, while the harness is
armed for the site, when the breaker those faults opened is open. Every
other failure of the device leg — ``KernelUnavailable``, a CUDA runtime
error, an out-of-memory error, a claimed nonce that fails the host
check, a programming error — raises ``KernelUnavailable`` after the
in-call retries, and so does an open breaker with no fault armed: a
missing or broken kernel must surface, not turn into the scalar nonce
loop (which needs days at difficulty 1).

Env knobs (read at configure time):
    BCP_BREAKER_THRESHOLD  consecutive failures to open (default 3)
    BCP_BREAKER_COOLDOWN   seconds open before probes start (default 5)
    BCP_BREAKER_PROBE      half-open probe probability (default 0.25)
    BCP_BREAKER_RETRIES    in-call retries before a failure counts (def. 1)
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..util import devicewatch as dw
from ..util import telemetry as tm
from ..util.faults import (INJECTOR, Backoff, InjectedFault, PoisonedOutput,
                           retry_call)
from ..util.log import log_print, log_printf
from .cuda_build import KernelUnavailable, raise_kernel_fault

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

# -- telemetry families (util/telemetry): per-subsystem dispatch latency
# split by the path that served the call, retry/fallback tallies, and a
# breaker-state collector projecting the live registry at scrape time.
_LAT = tm.histogram(
    "bcp_dispatch_latency_seconds",
    "Supervised backend-crossing latency per subsystem and serving path "
    "(device = the accelerator served it, cpu = breaker/failure fallback, "
    "settle = async handle materialization)",
    labels=("site", "path"))
_RETRIES = tm.counter(
    "bcp_dispatch_retries_total",
    "Same-call device retries absorbed by supervised dispatch",
    labels=("site",))
_FALLBACKS = tm.counter(
    "bcp_dispatch_fallback_total",
    "Calls served by the CPU engine because the device path was open or "
    "failed", labels=("site",))

_BREAKER_STATE_NUM = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _collect_breakers():
    """Registry collector: breaker state (0 closed / 1 half-open / 2 open)
    and the trip/probe/fallback tallies, one sample per subsystem."""
    snaps = snapshot()
    if not snaps:
        return []
    state = {"name": "bcp_breaker_state", "type": "gauge",
             "help": "Circuit-breaker state per subsystem "
                     "(0=closed 1=half-open 2=open)",
             "samples": []}
    out = [state]
    for field, help_ in (
        ("trips", "Times the breaker opened"),
        ("probes", "Half-open probes attempted"),
        ("recoveries", "Probes that closed the breaker"),
        ("fallback_calls", "Calls routed to the CPU engine"),
        ("fallback_items", "Items (sigs/hashes/leaves) served on CPU"),
    ):
        fam = {"name": f"bcp_breaker_{field}_total", "type": "counter",
               "help": help_, "samples": []}
        for name, snap in snaps.items():
            fam["samples"].append(({"subsystem": name}, snap[field]))
        out.append(fam)
    for name, snap in snaps.items():
        state["samples"].append(
            ({"subsystem": name}, _BREAKER_STATE_NUM[snap["state"]]))
    return out


tm.register_collector("dispatch_breakers", _collect_breakers)


@dataclass
class BreakerConfig:
    threshold: int = 3       # consecutive failures -> open
    cooldown: float = 5.0    # seconds open before probes may fire
    probe: float = 0.25      # half-open probe probability per allow()
    retries: int = 1         # same-call retries before a failure counts
    backoff_base: float = 0.02  # first retry delay (jittered, doubling)
    seed: Optional[int] = None  # probe rng seed (tests)

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        g = os.environ.get
        return cls(
            threshold=int(g("BCP_BREAKER_THRESHOLD", "3")),
            cooldown=float(g("BCP_BREAKER_COOLDOWN", "5")),
            probe=float(g("BCP_BREAKER_PROBE", "0.25")),
            retries=int(g("BCP_BREAKER_RETRIES", "1")),
        )


class CircuitBreaker:
    """Per-subsystem failure gate (closed -> open -> half-open -> closed).

    ``allow()`` answers "may this call try the device?"; callers then report
    record_success()/record_failure(). While OPEN, allow() flips to a
    HALF_OPEN probe with probability cfg.probe once the cooldown elapsed —
    probabilistic probing keeps a recovering device from being stampeded by
    every pending caller at once. Thread-safe: RPC threads and the P2P loop
    read state while the validation thread dispatches."""

    def __init__(self, name: str, cfg: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.name = name
        self.cfg = cfg if cfg is not None else BreakerConfig.from_env()
        self._clock = clock
        self._rng = random.Random(self.cfg.seed)
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0            # times the breaker opened
        self.opened_at = 0.0
        self.probes = 0           # half-open probes attempted
        self.recoveries = 0       # probes that closed the breaker
        self.fallback_calls = 0   # calls routed to the CPU engine
        self.fallback_items = 0   # items (sigs/hashes/leaves) in those calls
        self.last_error = ""

    def allow(self) -> bool:
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if (self._clock() - self.opened_at >= self.cfg.cooldown
                        and self._rng.random() < self.cfg.probe):
                    self.state = HALF_OPEN
                    self.probes += 1
                    return True
                return False
            # HALF_OPEN: one probe in flight; everyone else stays on CPU
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self.recoveries += 1
                log_printf("breaker %s: half-open probe succeeded — closed",
                           self.name)
            self.state = CLOSED
            self.consecutive_failures = 0

    def record_failure(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if err is not None:
                self.last_error = f"{type(err).__name__}: {err}"[:200]
            if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self.consecutive_failures >= self.cfg.threshold
            ):
                reopened = self.state == HALF_OPEN
                self.state = OPEN
                self.opened_at = self._clock()
                self.trips += 1
                log_printf(
                    "breaker %s: %s after %d consecutive failure(s) (%s)",
                    self.name, "re-opened" if reopened else "OPEN",
                    self.consecutive_failures, self.last_error)

    def note_fallback(self, items: int = 1) -> None:
        with self._lock:
            self.fallback_calls += 1
            self.fallback_items += max(0, int(items))
        _FALLBACKS.labels(site=self.name).inc()

    def healthy(self) -> bool:
        """Read-only probe: is the device path currently trusted? Unlike
        allow() this never mutates state (no half-open transition), so
        planners — e.g. the ecdsa cross-block lane packer deciding whether
        aggregating for full device buckets is worth the latency — can
        consult it per item without stealing recovery probes."""
        with self._lock:
            return self.state == CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips,
                "probes": self.probes,
                "recoveries": self.recoveries,
                "fallback_calls": self.fallback_calls,
                "fallback_items": self.fallback_items,
                "last_error": self.last_error,
            }


_CONFIG = BreakerConfig.from_env()
_BREAKERS: dict[str, CircuitBreaker] = {}
_REG_LOCK = threading.Lock()


def breaker(name: str) -> CircuitBreaker:
    with _REG_LOCK:
        br = _BREAKERS.get(name)
        if br is None:
            br = _BREAKERS[name] = CircuitBreaker(name, cfg=_CONFIG)
        return br


def configure(**kwargs) -> BreakerConfig:
    """Replace the breaker config (tests: threshold/cooldown/probe/seed)
    and rebuild the registry so it applies to every subsystem."""
    global _CONFIG
    base = BreakerConfig.from_env()
    for k, v in kwargs.items():
        setattr(base, k, v)
    _CONFIG = base
    with _REG_LOCK:
        _BREAKERS.clear()
    return base


def reset() -> None:
    """Drop all breaker state and re-read env config (test isolation)."""
    global _CONFIG
    _CONFIG = BreakerConfig.from_env()
    with _REG_LOCK:
        _BREAKERS.clear()


def snapshot() -> dict:
    """gettpuinfo's ``breakers`` section: every subsystem that has been
    touched this process, keyed by name."""
    with _REG_LOCK:
        return {name: br.snapshot() for name, br in _BREAKERS.items()}


def supervised_call(site: str, device_fn: Callable, cpu_fn: Callable,
                    validate: Optional[Callable] = None,
                    poison: Optional[Callable] = None,
                    items: int = 1):
    """Run one backend-crossing call under supervision.

    device_fn() is attempted (with cfg.retries same-call retries and
    jittered backoff between them) unless the breaker is open; its output
    is passed through ``validate`` (a cheap host-side probe returning
    truthy on sane output) before it is trusted. A fault the harness
    injected (an InjectedFault, or a failed validation of output that
    ``poison`` corrupted) counts one breaker failure after the retries,
    and the call is served by cpu_fn() instead. Any other exception or
    failed validation raises KernelUnavailable after the retries (a
    broken kernel), and so does an open breaker while no fault is armed
    for the site. ``poison`` is the fault harness's output-corruption
    hook (applied when BCP_FAULT_MODE=poison-output is armed for this
    site) — it exists so tests can prove the validation probe actually
    gates the verdict path.

    Returns (result, used_device)."""
    br = breaker(site)
    if br.allow():
        calls = [0]
        poisoned = [False]

        def attempt():
            calls[0] += 1
            poisoned[0] = False
            INJECTOR.on_call(site)
            out = device_fn()
            if poison is not None and INJECTOR.should_poison(site):
                out = poison(out)
                poisoned[0] = True
            if validate is not None and not validate(out):
                raise PoisonedOutput(
                    f"{site}: device output failed validation probe")
            return out

        t0 = time.monotonic()
        try:
            with tm.span("dispatch.call", site=site, items=items):
                out = retry_call(
                    attempt, attempts=br.cfg.retries + 1,
                    backoff=Backoff(base=br.cfg.backoff_base, maximum=1.0),
                )
            br.record_success()
            if calls[0] > 1:
                _RETRIES.labels(site=site).inc(calls[0] - 1)
            dt = time.monotonic() - t0
            _LAT.labels(site=site, path="device").observe(dt)
            # synchronous crossing: the whole device leg (dispatch +
            # blocking materialization inside device_fn) is one
            # "execute" phase — async sites split execute/fetch
            # themselves (util/devicewatch phase vocabulary)
            dw.note_phase(site, "execute", dt)
            return out, True
        except (KeyboardInterrupt, SystemExit, KernelUnavailable):
            raise
        except Exception as e:  # noqa: BLE001 — breaker boundary
            raise_kernel_fault(e, f"the {site} kernel")
            injected = isinstance(e, InjectedFault) or (
                isinstance(e, PoisonedOutput) and poisoned[0])
            if not injected:
                raise KernelUnavailable(
                    f"the {site} device leg failed: "
                    f"{type(e).__name__}: {e}") from e
            br.record_failure(e)
            if calls[0] > 1:
                _RETRIES.labels(site=site).inc(calls[0] - 1)
            log_print("tpu", "%s device call failed (%s) — CPU fallback",
                      site, e)
    elif not INJECTOR.armed_for(site):
        raise KernelUnavailable(
            f"the {site} breaker is open and no fault is injected "
            f"there: {br.snapshot()}")
    br.note_fallback(items)
    t0 = time.monotonic()
    out = cpu_fn()
    _LAT.labels(site=site, path="cpu").observe(time.monotonic() - t0)
    return out, False


class SupervisedHandle:
    """An enqueued device computation under breaker supervision — the async
    counterpart of supervised_call, for any site that wants to overlap
    host work with device settle (SURVEY.md §3.2 P3). The ECDSA pipeline
    itself rides its specialized equivalent (ecdsa_batch.BatchHandle,
    which adds KAT lanes and reject-side host confirmation); this is the
    GENERIC form for the other subsystems' future async crossings.

    The enqueue runs eagerly (breaker-gated, fault-injected); validation
    probes, breaker accounting, and the CPU fallback all run at result()
    time, so an unresolved handle can ride in a pipeline for many host
    steps without losing supervision. result() is memoized and safe to
    call from multiple consumers (the first settle pays; the rest read)."""

    __slots__ = ("_site", "_pending", "_cpu_fn", "_validate", "_poison",
                 "_items", "_result", "_done", "used_device", "_ctx")

    def __init__(self, site, pending, cpu_fn, validate, poison, items,
                 used_device, ctx=None):
        self._site = site
        self._pending = pending      # zero-arg materializer, or None
        self._cpu_fn = cpu_fn
        self._validate = validate
        self._poison = poison
        self._items = items
        self._result = None
        self._done = pending is None
        self.used_device = used_device
        # trace-correlation handoff: the enqueue-side span context rides
        # the handle so the settle span — often on ANOTHER thread — links
        # back to the dispatching block's correlation chain
        self._ctx = ctx
        if self._done:
            self._result = cpu_fn()  # CPU path is synchronous anyway

    def result(self):
        if self._done:
            return self._result
        br = breaker(self._site)
        t0 = time.monotonic()
        try:
            with tm.span("dispatch.settle", parent=self._ctx,
                         site=self._site, items=self._items):
                out = self._pending()
            if self._poison is not None and INJECTOR.should_poison(self._site):
                out = self._poison(out)
            if self._validate is not None and not self._validate(out):
                raise PoisonedOutput(
                    f"{self._site}: device output failed validation probe")
            br.record_success()
            dt = time.monotonic() - t0
            _LAT.labels(site=self._site, path="settle").observe(dt)
            # async crossing: result() blocks on materialization — the
            # "fetch" phase of the dispatch decomposition
            dw.note_phase(self._site, "fetch", dt)
            self._result = out
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — breaker boundary
            br.record_failure(e)
            br.note_fallback(self._items)
            log_print("tpu", "%s async settle failed (%s) — CPU fallback",
                      self._site, e)
            self._result = self._cpu_fn()
            self.used_device = False
        self._pending = None
        self._done = True
        return self._result


def supervised_enqueue(site: str, enqueue_fn: Callable, cpu_fn: Callable,
                       validate: Optional[Callable] = None,
                       poison: Optional[Callable] = None,
                       items: int = 1) -> SupervisedHandle:
    """Async supervised dispatch: enqueue_fn() must START the device work
    and return a zero-arg materializer that blocks until it settles (JAX
    async dispatch returns array futures, so `lambda: np.asarray(dev_out)`
    is the usual shape). A breaker-open site, or an enqueue_fn that raises,
    degrades to a handle whose result() is cpu_fn() — the caller's pipeline
    shape is preserved either way."""
    br = breaker(site)
    if br.allow():
        try:
            with tm.span("dispatch.enqueue", site=site, items=items):
                INJECTOR.on_call(site)
                pending = enqueue_fn()
                ctx = tm.trace_context()  # the enqueue span itself
            return SupervisedHandle(site, pending, cpu_fn, validate, poison,
                                    items, used_device=True, ctx=ctx)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — breaker boundary
            br.record_failure(e)
            log_print("tpu", "%s async enqueue failed (%s) — CPU fallback",
                      site, e)
    br.note_fallback(items)
    return SupervisedHandle(site, None, cpu_fn, validate, poison, items,
                            used_device=False)


# ---------------------------------------------------------------------------
# Subsystem front doors used by validation/ and mining/ (lazy device import
# so CPU-only paths and crash-test workers never load the kernel modules).
# ---------------------------------------------------------------------------

def _merkle_device_min() -> int:
    """Leaf-count floor for the device Merkle path: below it the dispatch
    round trip loses to the host loop (and ordinary regtest blocks stay on
    the byte-exact CPU reference)."""
    return int(os.environ.get("BCP_TPU_MERKLE_MIN", "512"))


def merkle_root(hashes: list, expected: Optional[bytes] = None) -> tuple:
    """Supervised Merkle root: device tree-reduction for large leaf sets,
    reference CPU loop otherwise (and for an injected fault at the merkle
    site; any other device failure raises KernelUnavailable).

    ``expected`` is the caller's claimed root (the block header's). A
    device result is never the sole basis for a VERDICT CHANGE in either
    direction:

    - reject side: a device root mismatch or mutated=True is confirmed by
      a full CPU recompute before it is returned — the witness probe
      catches gross corruption cheaply, but a single corrupted interior
      lane could otherwise pass it and make a lying device reject a valid
      block (forking the node off the honest chain);
    - accept side: a device mutated=False is only trusted when the leaf
      set has no duplicates. Equal interior nodes require equal leaf
      subsequences (absent SHA-256 collisions), so distinct leaves imply
      no CVE-2012-2459 mutation; any duplicate leaf forces the CPU
      reference to produce the flag.

    A bad device may cost one CPU recompute, never a verdict."""
    if len(hashes) >= _merkle_device_min():
        from ..consensus.merkle import compute_merkle_root
        from .merkle import compute_merkle_root_tpu_ex

        root, mutated, used_device = compute_merkle_root_tpu_ex(hashes)
        if used_device and (
            mutated
            or (expected is not None and root != expected)
            or len(set(hashes)) != len(hashes)
        ):
            return compute_merkle_root(hashes)
        return root, mutated
    from ..consensus.merkle import compute_merkle_root

    return compute_merkle_root(hashes)


def block_merkle_root(block) -> tuple:
    """BlockMerkleRoot through the supervised chooser (chainstate's
    check_block entry); the header's claimed root gates reject-path
    CPU confirmation."""
    return merkle_root([tx.txid for tx in block.vtx],
                       expected=block.header.hash_merkle_root)


def supervised_resident_sweep(resident):
    """Wrap a mining/resident.ResidentSweep's persistent loop in miner
    supervision: the resident segment pipeline (template swaps, candidate
    FIFO, nonce rollover) runs as the device path, a claimed hit is host
    re-verified, and an injected device fault degrades to the scalar host
    loop under the same miner circuit breaker as the per-dispatch path;
    any other failure raises KernelUnavailable."""
    return supervised_sweep(inner=resident.sweep)


def supervised_sweep(inner=None):
    """Wrap a PoW sweep implementation (ops/miner.sweep_header,
    ops/sha256_sweep.sweep_header_fast, ops/pallas_sweep.
    sweep_header_pallas, mining/resident.ResidentSweep.sweep) in miner
    supervision: a claimed hit is re-verified on host before it is trusted
    (2 hashes — free next to a sweep); an injected fault degrades to the
    scalar CPU loop, the reference generateBlocks inner loop, and any
    other failure raises KernelUnavailable (supervised_call). Returns a
    callable with the sweep_header signature."""
    def sweep(header80: bytes, target: int, start_nonce: int = 0,
              max_nonces: int = 1 << 32, tile: Optional[int] = None):
        from ..crypto.hashes import sha256d
        from .miner import DEFAULT_TILE, sweep_header_cpu

        dev = inner
        if dev is None:
            from .miner import sweep_header as dev  # noqa: PLC0415

        eff_tile = DEFAULT_TILE if tile is None else tile

        def device():
            return dev(header80, target, start_nonce=start_nonce,
                       max_nonces=max_nonces, tile=eff_tile)

        def cpu():
            return sweep_header_cpu(header80, target, start_nonce=start_nonce,
                                    max_nonces=max_nonces)

        def validate(res):
            nonce, _hashes = res
            if nonce is None:
                return True  # a missed hit costs work, never consensus
            hdr = header80[:76] + int(nonce).to_bytes(4, "little")
            return int.from_bytes(sha256d(hdr), "little") <= target

        def poison(res):
            nonce, hashes = res
            bad = (nonce ^ 1) if nonce is not None else start_nonce
            return (bad & 0xFFFFFFFF, hashes)

        out, _ = supervised_call("miner", device, cpu,
                                 validate=validate, poison=poison,
                                 items=1)
        return out

    return sweep
