"""Device-lane observability for the PyTorch/CUDA port.

Counterpart of the reference's util/devicewatch.py. What carries over:

- **Shape sentinel** (``program()``/``ProgramWatch.dispatch``): each
  watched kernel entry counts launches per shape signature (for the ECDSA
  kernels, the padded bucket). A signature never seen before counts as a
  new shape, and the wall time of that first launch is booked to it (the
  first launch of the process also pays the kernel build). A program that
  grows more distinct signatures than its DECLARED shape budget fires
  ``bcp_kernel_shape_unexpected_total{program}``, a trace instant and a
  log warning: the bucket design's bounded-shape invariant, checked at
  run time.
- **Transfer & memory accounting** (``note_transfer``, the
  ``devicewatch_memory`` collector): host<->device bytes per site and
  direction, transfer-time histograms where a site can isolate the wait,
  and ``torch.cuda.memory_stats()`` projected into gauges once CUDA is
  initialised (nothing on the CPU).
- **Dispatch phases** (``phase()``, ``note_phase``): pack/transfer/
  execute/fetch legs into ``bcp_dispatch_phase_seconds{site,phase}``.
- **Stall watchdog** (``Watchdog``/``WATCHDOG``): framework-free, as in the
  reference (observe-only).

- **Compile cache** (``enable_compile_cache``, ``compile_cache_snapshot``:
  the node's ``-compilecache=<dir>``): PyTorch runs eagerly and has no
  program to cache, so the port's cache is the kernel library directory
  of ops/cuda_build (a library there whose hash matches is loaded with no
  nvcc run).

- **On-demand profiler** (``start_profile``/``stop_profile``: the
  ``startprofile``/``stopprofile`` RPCs): ``torch.profiler`` (CPU
  activity, and CUDA activity under the CUDA switch: the card's kernels
  by name) around the window, dumped as a Chrome trace,
  ``<dir>/trace.json``. The profiler lives on a thread of its own for the
  window: torch's profiler must be stopped on the thread that started
  it, and the RPCs arrive on different threads.
- ``snapshot()`` (gettpuinfo's ``device`` section) and ``reset()``, with
  the reference's keys.

No CUDA work at import: the memory collector reads CUDA state only after
something else initialised it.

Env knobs:
    BCP_WATCHDOG_QUIET     default stall quiet period, seconds (10)
    BCP_WATCHDOG_INTERVAL  global watchdog ticker cadence, seconds (1)
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from . import telemetry as tm
from .log import log_printf

_FIRST_H = tm.histogram(
    "bcp_kernel_first_launch_seconds",
    "Wall seconds of the first launch of each new shape of a watched "
    "kernel entry (the process's first launch includes the kernel build)",
    labels=("program",),
    buckets=(0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0))
_SHAPES_C = tm.counter(
    "bcp_kernel_new_shapes_total",
    "Launches of a watched kernel entry with a shape signature not seen "
    "before in this process",
    labels=("program",))
_UNEXPECTED_C = tm.counter(
    "bcp_kernel_shape_unexpected_total",
    "New shape signatures beyond a program's declared shape budget — the "
    "bounded-shape invariant, violated",
    labels=("program",))
_XFER_B = tm.counter(
    "bcp_device_transfer_bytes_total",
    "Bytes crossing the host<->device boundary per site and direction "
    "(h2d = staging, d2h = result fetch)",
    labels=("site", "direction"))
_XFER_H = tm.histogram(
    "bcp_device_transfer_seconds",
    "Transfer wait where a site can isolate it (result fetch)",
    labels=("site", "direction"),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0))
_PHASE_H = tm.histogram(
    "bcp_dispatch_phase_seconds",
    "Per-dispatch phase decomposition (pack = host byte-matrix emit, "
    "transfer = explicit staging, execute = kernel enqueue, fetch = "
    "blocking result materialization)",
    labels=("site", "phase"))
_WD_STALLED_G = tm.gauge(
    "bcp_watchdog_stalled",
    "1 while a subsystem has pending work but made no progress for its "
    "quiet period, else 0 (observe-only — no kill action)",
    labels=("subsystem",))
_WD_EPISODES_C = tm.counter(
    "bcp_watchdog_stall_episodes_total",
    "Stall episodes detected per subsystem",
    labels=("subsystem",))
_WD_IDLE_G = tm.gauge(
    "bcp_watchdog_idle_seconds",
    "Seconds since the subsystem's last progress beat",
    labels=("subsystem",))


# ---------------------------------------------------------------------------
# Shape sentinel
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_PROGRAMS: dict[str, "ProgramWatch"] = {}


class ProgramWatch:
    """Per-entry launch/shape accounting around a kernel wrapper.

    ``dispatch(sig)`` wraps ONE call: ``sig`` is the shape signature the
    caller derives from its bucketing. ``shape_budget`` declares how many
    distinct signatures the bucket design allows — one more is an
    invariant violation and fires the sentinel."""

    def __init__(self, name: str, shape_budget: Optional[int] = None):
        self.name = name
        self.shape_budget = shape_budget
        self.signatures: dict[tuple, int] = {}
        self.dispatches = 0
        self.new_shapes = 0
        self.first_launch_seconds = 0.0
        self.retraces_unexpected = 0
        self.warnings = 0
        self.last_warning = ""

    @contextmanager
    def dispatch(self, *sig_parts):
        """Wrap one kernel call. Bookkeeping runs even when the call
        raises (a failed launch still consumed a shape attempt)."""
        sig = tuple(sig_parts)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._after_dispatch(sig, time.perf_counter() - t0)

    def _after_dispatch(self, sig, dt) -> None:
        with _LOCK:
            new = sig not in self.signatures
            self.signatures[sig] = self.signatures.get(sig, 0) + 1
            self.dispatches += 1
            if new:
                self.new_shapes += 1
                self.first_launch_seconds += dt
            over_budget = (new and self.shape_budget is not None
                           and len(self.signatures) > self.shape_budget)
            if over_budget:
                self.retraces_unexpected += 1
                self.warnings += 1
                self.last_warning = (
                    f"program {self.name!r}: unexpected shape — signature "
                    f"{sig!r} is distinct shape #{len(self.signatures)} "
                    f"against a declared budget of {self.shape_budget} "
                    f"(bounded-shape invariant violated)")
        if new:
            _SHAPES_C.labels(program=self.name).inc()
            _FIRST_H.labels(program=self.name).observe(dt)
        if over_budget:
            _UNEXPECTED_C.labels(program=self.name).inc()
            tm.instant("devicewatch.shape_unexpected",
                       program=self.name, sig=str(sig),
                       shapes=len(self.signatures),
                       budget=self.shape_budget)
            log_printf("WARNING: %s", self.last_warning)

    def snapshot(self) -> dict:
        with _LOCK:
            return {
                "dispatches": self.dispatches,
                "new_shapes": self.new_shapes,
                "first_launch_seconds": round(self.first_launch_seconds, 4),
                "shapes": len(self.signatures),
                "shape_budget": self.shape_budget,
                "retraces_unexpected": self.retraces_unexpected,
                "signatures": {str(k): v
                               for k, v in sorted(self.signatures.items())},
                "last_warning": self.last_warning,
            }


def program(name: str, shape_budget: Optional[int] = None) -> ProgramWatch:
    """Get-or-register the watch for one kernel entry. A later caller
    passing a budget upgrades a budget-less registration."""
    with _LOCK:
        pw = _PROGRAMS.get(name)
        if pw is None:
            pw = _PROGRAMS[name] = ProgramWatch(name, shape_budget)
        elif shape_budget is not None and pw.shape_budget is None:
            pw.shape_budget = shape_budget
        return pw


# ---------------------------------------------------------------------------
# Transfer accounting + phase profiling
# ---------------------------------------------------------------------------

_TRANSFERS: dict[tuple, int] = {}  # (site, direction) -> bytes


def note_transfer(site: str, direction: str, nbytes: int,
                  seconds: Optional[float] = None) -> None:
    """Account one host<->device crossing: bytes always, wait time only
    when the caller measured a real blocking transfer (direction is
    "h2d" or "d2h")."""
    n = int(nbytes)
    with _LOCK:
        _TRANSFERS[(site, direction)] = \
            _TRANSFERS.get((site, direction), 0) + n
    _XFER_B.labels(site=site, direction=direction).inc(n)
    if seconds is not None:
        _XFER_H.labels(site=site, direction=direction).observe(seconds)


def note_phase(site: str, phase_name: str, seconds: float) -> None:
    _PHASE_H.labels(site=site, phase=phase_name).observe(seconds)


@contextmanager
def phase(site: str, phase_name: str):
    """Time one dispatch phase (pack/transfer/execute/fetch) into the
    per-site phase histogram."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        note_phase(site, phase_name, time.perf_counter() - t0)


# the compile cache (-compilecache / BCP_COMPILE_CACHE -> enable_compile_cache)
_COMPILE_CACHE = {"dir": None, "enabled": False}


def enable_compile_cache(path: str) -> dict:
    """The node's -compilecache=<dir> (default OFF): point ops/cuda_build's
    kernel library directory at ``path`` (created), so that a later
    process with the same directory loads the libraries it finds there
    instead of running nvcc (it takes effect at the process's first kernel
    build). Seeds BCP_COMPILE_CACHE so subprocesses inherit it. Raises
    OSError or ValueError (os.makedirs on a bad path), as the reference's
    does."""
    from ..ops import cuda_build

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    cuda_build.BUILD_DIR = path
    os.environ["BCP_COMPILE_CACHE"] = path
    with _LOCK:
        _COMPILE_CACHE["dir"] = path
        _COMPILE_CACHE["enabled"] = True
    return compile_cache_snapshot()


def compile_cache_snapshot() -> dict:
    """Compile-cache state with the reference's keys: directory, enabled
    flag, cache_hits (kernel libraries this process loaded without an nvcc
    run) and the build's events (libraries built and reused)."""
    from ..ops import cuda_build

    info = cuda_build.BUILD_INFO
    hits = info.get("reused", 0)
    events = ({"cache_hits": hits, "builds": len(info["libraries"]) - hits}
              if info else {})
    with _LOCK:
        return {
            "dir": _COMPILE_CACHE["dir"],
            "enabled": _COMPILE_CACHE["enabled"],
            "cache_hits": hits,
            "events": events,
        }


def transfer_snapshot() -> dict:
    with _LOCK:
        out: dict[str, dict] = {}
        for (site, direction), n in sorted(_TRANSFERS.items()):
            out.setdefault(site, {})[direction] = n
        return out


# ---------------------------------------------------------------------------
# On-demand torch.profiler wrapper (startprofile / stopprofile RPCs)
# ---------------------------------------------------------------------------

_PROFILE = {"active": False, "path": None, "t0": 0.0, "dumps": 0}
# the window's thread: its stop event, its "started" and "done" events and
# the error it met, if any
_PROFILER: dict = {}


def _profile_window(logdir: str, activities: list, ctl: dict) -> None:
    """The profiler's thread: start, wait for the stop event, stop and
    write <logdir>/trace.json (torch's profiler must stop on the thread
    that started it)."""
    from torch.profiler import profile

    try:
        prof = profile(activities=activities)
        prof.start()
    except BaseException as e:  # noqa: BLE001 — handed to start_profile
        ctl["error"] = e
        ctl["started"].set()
        return
    ctl["started"].set()
    ctl["stop"].wait()
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    except BaseException as e:  # noqa: BLE001 — handed to stop_profile
        ctl["error"] = e
    ctl["done"].set()


def start_profile(logdir: str) -> dict:
    """Start a torch.profiler trace into ``logdir`` (CPU activity, and
    CUDA activity under the CUDA switch; ``stop_profile`` writes
    <logdir>/trace.json). Raises RuntimeError when a profile is already
    running (the profiler is process-global)."""
    from torch.profiler import ProfilerActivity

    from ..ops import cuda_build

    with _LOCK:
        if _PROFILE["active"]:
            raise RuntimeError(
                f"profiler already active (dir: {_PROFILE['path']})")
        _PROFILE["active"] = True
        _PROFILE["path"] = logdir
        _PROFILE["t0"] = time.monotonic()
    try:
        os.makedirs(logdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if cuda_build.require_device("the profiler").type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctl = {"stop": threading.Event(), "started": threading.Event(),
               "done": threading.Event(), "error": None}
        threading.Thread(target=_profile_window, name="bcp-profiler",
                         args=(logdir, activities, ctl), daemon=True).start()
        ctl["started"].wait()
        if ctl["error"] is not None:
            raise ctl["error"]
        _PROFILER.update(ctl)
    except BaseException:
        with _LOCK:
            _PROFILE["active"] = False
            _PROFILE["path"] = None
        raise
    return {"path": logdir, "active": True}


def stop_profile() -> dict:
    """Stop the running torch.profiler trace and write its Chrome trace;
    returns {path, seconds}. Raises RuntimeError when no profile is
    running."""
    with _LOCK:
        if not _PROFILE["active"]:
            raise RuntimeError("profiler not active (startprofile first)")
        path = _PROFILE["path"]
        seconds = time.monotonic() - _PROFILE["t0"]
    try:
        _PROFILER["stop"].set()
        _PROFILER["done"].wait()
        if _PROFILER["error"] is not None:
            raise _PROFILER["error"]
    finally:
        _PROFILER.clear()
        with _LOCK:
            _PROFILE["active"] = False
            _PROFILE["path"] = None
            _PROFILE["dumps"] += 1
    return {"path": path, "seconds": round(seconds, 3)}


def profile_snapshot() -> dict:
    with _LOCK:
        return {"active": _PROFILE["active"], "path": _PROFILE["path"],
                "dumps": _PROFILE["dumps"]}


# ---------------------------------------------------------------------------
# Device-memory collector (CUDA only, once initialised)
# ---------------------------------------------------------------------------


def _cuda_devices() -> int:
    """CUDA devices visible, WITHOUT initialising CUDA: a metrics scrape
    must not be what creates the CUDA context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        if not torch.cuda.is_initialized():
            return 0
        return int(torch.cuda.device_count())
    except Exception:  # noqa: BLE001 — scrape must survive a dead device
        return 0


def _collect_device_memory():
    """Registry collector: torch.cuda.memory_stats() per device, projected
    into gauges. The families are emitted (empty) on the CPU as well, so
    the namespace is stable."""
    mem = {"name": "bcp_device_memory_bytes", "type": "gauge",
           "help": "torch.cuda.memory_stats() projection (allocated_bytes,"
                   " reserved_bytes, ... per device)",
           "samples": []}
    n = _cuda_devices()
    torch = sys.modules.get("torch")
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:  # noqa: BLE001 — per-device probe
            continue
        for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                  "reserved_bytes.all.current"):
            if k in stats:
                mem["samples"].append(
                    ({"device": f"cuda:{i}", "stat": k}, float(stats[k])))
    count = {"name": "bcp_device_count", "type": "gauge",
             "help": "CUDA devices visible to the process (0 until CUDA is "
                     "initialised by real work)",
             "samples": [({}, float(n))]}
    return [mem, count]


def _collect_programs():
    """Registry collector: per-program distinct-shape counts."""
    with _LOCK:
        shapes = {name: len(pw.signatures) for name, pw in _PROGRAMS.items()}
    if not shapes:
        return []
    return [{
        "name": "bcp_kernel_program_shapes", "type": "gauge",
        "help": "Distinct shape signatures seen per watched kernel entry "
                "(compare against the declared budget)",
        "samples": [({"program": n}, v) for n, v in sorted(shapes.items())],
    }]


tm.register_collector("devicewatch_memory", _collect_device_memory)
tm.register_collector("devicewatch_programs", _collect_programs)


# ---------------------------------------------------------------------------
# Stall watchdog (observe-only)
# ---------------------------------------------------------------------------

def _default_quiet() -> float:
    try:
        return float(os.environ.get("BCP_WATCHDOG_QUIET", "10"))
    except ValueError:
        return 10.0


class Watchdog:
    """No-progress sentinel. Subsystems register a ``pending_fn`` (how
    many units of work are parked right now — must be lock-free/cheap)
    and ``beat()`` on every unit of progress. ``check()`` marks a
    subsystem stalled when it has pending work and the last beat is
    older than its quiet period; the episode fires the counter, a log
    warning, and a trace instant ONCE per stall, and clears on the next
    beat (or when the pending work drains). Observe-only: no kill, no
    restart — the breaker/fallback machinery owns recovery.

    ``clock`` is injectable (fake-clock unit tests); the process-global
    ``WATCHDOG`` additionally runs a lazy 1 Hz daemon ticker so stalls
    surface even when nobody scrapes /metrics."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 auto_ticker: bool = False):
        self._clock = clock
        self._auto_ticker = auto_ticker
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._beat_totals: dict[str, int] = {}
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()

    def register(self, subsystem: str, pending_fn: Callable[[], int],
                 quiet_s: Optional[float] = None) -> None:
        """(Re-)register a subsystem; a fresh owner supersedes a closed
        one's closure by name. quiet_s <= 0 disables detection for the
        subsystem (gauges still export)."""
        q = _default_quiet() if quiet_s is None else float(quiet_s)
        with self._lock:
            self._entries[subsystem] = {
                "pending_fn": pending_fn, "quiet_s": q,
                "last_beat": self._clock(), "stalled": False,
                "episodes": 0, "beats": 0,
            }
        _WD_STALLED_G.labels(subsystem=subsystem).set(0)
        if self._auto_ticker:
            self._ensure_ticker()

    def unregister(self, subsystem: str) -> None:
        with self._lock:
            self._entries.pop(subsystem, None)

    def beat(self, subsystem: str) -> None:
        """Record one unit of progress. Unregistered names are a cheap
        no-op."""
        with self._lock:
            self._beat_totals[subsystem] = \
                self._beat_totals.get(subsystem, 0) + 1
            ent = self._entries.get(subsystem)
            if ent is None:
                return
            ent["last_beat"] = self._clock()
            ent["beats"] += 1
            was_stalled, ent["stalled"] = ent["stalled"], False
        if was_stalled:
            _WD_STALLED_G.labels(subsystem=subsystem).set(0)
            log_printf("watchdog: %s recovered (progress beat)", subsystem)
            tm.instant("watchdog.recovered", subsystem=subsystem)

    def check(self, now: Optional[float] = None) -> list[str]:
        """Evaluate every subsystem; returns the currently-stalled names."""
        now = self._clock() if now is None else now
        with self._lock:
            entries = list(self._entries.items())
        stalled_names = []
        for name, ent in entries:
            try:
                pending = int(ent["pending_fn"]())
            except Exception:  # noqa: BLE001 — a dead probe isn't a stall
                pending = 0
            idle = max(0.0, now - ent["last_beat"])
            _WD_IDLE_G.labels(subsystem=name).set(round(idle, 3))
            is_stalled = (pending > 0 and ent["quiet_s"] > 0
                          and idle >= ent["quiet_s"])
            fire = clear = False
            with self._lock:
                live = self._entries.get(name)
                if live is not ent:
                    continue  # re-registered mid-check
                if is_stalled and not ent["stalled"]:
                    ent["stalled"] = True
                    ent["episodes"] += 1
                    fire = True
                elif not is_stalled and ent["stalled"]:
                    ent["stalled"] = False
                    clear = True
            if fire:
                _WD_STALLED_G.labels(subsystem=name).set(1)
                _WD_EPISODES_C.labels(subsystem=name).inc()
                log_printf(
                    "WARNING: watchdog: %s stalled — %d pending unit(s), "
                    "no progress for %.1fs (quiet period %.1fs); "
                    "observe-only, no action taken",
                    name, pending, idle, ent["quiet_s"])
                tm.instant("watchdog.stalled", subsystem=name,
                           pending=pending, idle_s=round(idle, 3),
                           quiet_s=ent["quiet_s"])
            elif clear:
                _WD_STALLED_G.labels(subsystem=name).set(0)
                log_printf("watchdog: %s recovered (pending drained)", name)
            if is_stalled:
                stalled_names.append(name)
        return stalled_names

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                name: {
                    "stalled": ent["stalled"],
                    "episodes": ent["episodes"],
                    "beats": ent["beats"],
                    "quiet_s": ent["quiet_s"],
                    "idle_s": round(max(0.0, now - ent["last_beat"]), 3),
                }
                for name, ent in self._entries.items()
            }

    def beat_totals(self) -> dict:
        """Cumulative beats per subsystem across registrations."""
        with self._lock:
            return dict(self._beat_totals)

    # -- ticker ---------------------------------------------------------

    def _ensure_ticker(self) -> None:
        with self._lock:
            if self._ticker is not None and self._ticker.is_alive():
                return
            self._ticker_stop.clear()
            self._ticker = threading.Thread(
                target=self._tick_loop, name="devicewatch-watchdog",
                daemon=True)
            self._ticker.start()

    def _tick_loop(self) -> None:
        try:
            interval = float(os.environ.get("BCP_WATCHDOG_INTERVAL", "1"))
        except ValueError:
            interval = 1.0
        interval = max(0.05, interval)
        while not self._ticker_stop.wait(interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the ticker must survive
                pass

    def stop_ticker(self) -> None:
        self._ticker_stop.set()
        with self._lock:
            t, self._ticker = self._ticker, None
        if t is not None:
            t.join(timeout=5)


WATCHDOG = Watchdog(auto_ticker=True)


def _collect_watchdog():
    """Scrape-time evaluation: a /metrics pull re-checks every subsystem."""
    WATCHDOG.check()
    return []


tm.register_collector("devicewatch_watchdog", _collect_watchdog)


# ---------------------------------------------------------------------------
# gettpuinfo's "device" section
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    """The device-lane monitor's full state, with the reference's keys:
    per-program launch/shape accounting, transfer totals, the compile
    cache, the profiler state and the watchdog. ``unattributed_compiles``
    stays zero: the port compiles nothing outside a watched launch (its
    one build, the kernel libraries', runs inside the first)."""
    with _LOCK:
        programs = {name: pw for name, pw in sorted(_PROGRAMS.items())}
    return {
        "programs": {name: pw.snapshot() for name, pw in programs.items()},
        "transfer_bytes": transfer_snapshot(),
        "unattributed_compiles": {"compile_s": 0.0, "events": 0},
        "compilation_cache": compile_cache_snapshot(),
        "profiler": profile_snapshot(),
        "watchdog": WATCHDOG.snapshot(),
    }


def reset() -> None:
    """Test isolation: drop program watches, transfer tallies, and
    watchdog registrations (the global families live in the telemetry
    registry and are zeroed by telemetry.reset())."""
    with _LOCK:
        _PROGRAMS.clear()
        _TRANSFERS.clear()
    with WATCHDOG._lock:
        WATCHDOG._entries.clear()
        WATCHDOG._beat_totals.clear()
