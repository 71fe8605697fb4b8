"""Unified telemetry — process-global metrics registry + pipeline span tracer.

Every performance claim before this layer was projection-grade: the node's
instrumentation was a patchwork of ad-hoc ``STATS`` dataclasses and one-off
``snapshot()`` methods, aggregatable only by hand, with no latency
distributions and no way to see where wall-clock goes inside the pipelined
settle horizon. This module is the single aggregation surface:

- **Metrics registry** (``REGISTRY``): counters, gauges, and fixed-bucket
  latency histograms with p50/p90/p99 estimation, grouped into labeled
  families (Prometheus data model). Hot layers create their families at
  import time and record per-batch/per-block/per-tx — never per-sig.
  Modules that already keep their own counters (ops/ecdsa_batch.STATS,
  ops/dispatch breakers, sigcache, the pipeline stats, connman's
  net_stats) are migrated onto the registry via **collectors**: scrape-time
  callbacks that project the live state into families, so ``getmetrics``
  and ``/metrics`` see one namespace while ``gettpuinfo`` keeps its
  established shape as a thin view over the same sources.

- **Span tracer** (``TRACER``): ``with span("block.scan", height=h):``
  context managers record completed spans into a bounded ring buffer with
  thread + correlation ids; nested spans carry parent links, and a
  correlation context can be handed across the supervised-dispatch thread
  boundary (``trace_context()`` at enqueue, ``parent=ctx`` at settle) so a
  batch settled on another thread still traces back to the block that
  dispatched it. Export is Chrome-trace/perfetto JSON (``chrome_trace()``,
  ``dump()``; surfaced via the ``dumptrace`` RPC and the ``-tracefile``
  shutdown hook).

Gating: ``-telemetry=off|counters|trace`` (env ``BCP_TELEMETRY`` seeds the
default for subprocesses). ``off`` turns every record call into a cheap
flag check; ``counters`` (default) enables the registry with a
bench-proven overhead budget (< 2 % on the import_pipeline corpus —
bench.py telemetry_overhead / BENCH_r06.json); ``trace`` additionally
records spans.

Metric naming scheme: ``bcp_<subsystem>_<what>[_<unit>]`` — e.g.
``bcp_dispatch_latency_seconds{site="ecdsa",path="device"}``,
``bcp_pipeline_scan_seconds``, ``bcp_mempool_accept_seconds{result=...}``.
Durations are seconds; sizes are lanes/bytes; states are small-int gauges.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Sequence

MODES = ("off", "counters", "trace")

_MODE: Optional[str] = None  # resolved lazily from BCP_TELEMETRY


def mode() -> str:
    """The active telemetry level. An invalid BCP_TELEMETRY value falls
    back to the default with no error — the -telemetry flag is the
    validated front door (node startup rejects junk)."""
    global _MODE
    if _MODE is None:
        env = os.environ.get("BCP_TELEMETRY", "counters")
        _MODE = env if env in MODES else "counters"
    return _MODE


def set_mode(name: str) -> str:
    """Select the telemetry level; raises ValueError on unknown names
    (node startup turns that into a ConfigError)."""
    global _MODE
    if name not in MODES:
        raise ValueError(
            f"-telemetry={name!r}: unknown level "
            f"(valid: {', '.join(MODES)})"
        )
    _MODE = name
    return name


def metrics_enabled() -> bool:
    return mode() != "off"


def trace_enabled() -> bool:
    return mode() == "trace"


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

# Default latency buckets (seconds): geometric 1-2.5-5 ladder from 100 µs
# to 60 s — wide enough for a device dispatch and a whole-block settle.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter. inc() is lock-protected — concurrent writers
    (RPC threads, the P2P loop, validation) never lose increments."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics (bucket i
    counts observations <= bounds[i]; the last slot is +Inf overflow) and
    interpolated quantile estimation (the histogram_quantile formula:
    linear within the target bucket)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or not bounds:
            raise ValueError(f"histogram buckets must ascend: {buckets!r}")
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not metrics_enabled():
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 < q <= 1). Rank = q * count; the bucket
        where the cumulative count first reaches the rank is interpolated
        linearly between its bounds. Observations beyond the last finite
        bound clamp to it (Prometheus histogram_quantile behavior). 0.0
        when the histogram is empty."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total <= 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]  # overflow: clamp to last bound
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if c <= 0:
                    return hi
                return lo + (hi - lo) * (rank - (cum - c)) / c
        return self.bounds[-1]

    def quantiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99)) -> dict:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: a set of children keyed by label values
    (Prometheus data model). An unlabeled family has exactly one child and
    proxies inc/set/observe straight to it."""

    __slots__ = ("name", "help", "type", "labelnames", "_buckets",
                 "_lock", "_children")

    def __init__(self, name: str, typ: str, help: str = "",
                 labels: Sequence[str] = (), buckets=None):
        self.name = name
        self.help = help
        self.type = typ
        self.labelnames = tuple(labels)
        self._buckets = tuple(buckets) if buckets else None
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._make()

    def _make(self):
        if self.type == "histogram" and self._buckets:
            return Histogram(self._buckets)
        return _TYPES[self.type]()

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    # unlabeled conveniences
    def inc(self, n: float = 1.0) -> None:
        self._children[()].inc(n)

    def set(self, v: float) -> None:
        self._children[()].set(v)

    def observe(self, v: float) -> None:
        self._children[()].observe(v)

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        return self._children[()].quantiles(qs)

    def samples(self) -> list:
        """[(labels_dict, child), ...] in insertion order."""
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.labelnames, key)), child) for key, child in items
        ]

    def _zero(self) -> None:
        with self._lock:
            for key in list(self._children):
                self._children[key] = self._make()
            if not self.labelnames and () not in self._children:
                self._children[()] = self._make()


class Registry:
    """Process-global metric namespace. Families register once (import
    time); ``collectors`` are scrape-time callbacks that project existing
    state objects (STATS dataclasses, breaker registries, per-node caches)
    into families — the migration path for the pre-telemetry snapshot()
    surfaces. Collector exceptions are swallowed per collector (a closed
    node's stale collector must not take /metrics down)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}
        self._collectors: dict[str, Callable[[], Iterable[dict]]] = {}

    def _family(self, name, typ, help, labels, buckets=None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Family(
                    name, typ, help, labels, buckets)
            elif fam.type != typ or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {typ}{tuple(labels)} "
                    f"(was {fam.type}{fam.labelnames})")
            return fam

    def counter(self, name, help="", labels=()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(), buckets=None) -> Family:
        return self._family(name, "histogram", help, labels, buckets)

    def register_collector(self, name: str, fn: Callable) -> None:
        """fn() -> iterable of {"name", "type", "help", "samples":
        [(labels_dict, value), ...]} — counter/gauge families only.
        Re-registering a name replaces the previous collector (a fresh
        node supersedes a closed one's closures)."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def reset(self) -> None:
        """Zero every registered family's samples (test isolation).
        Families and collectors SURVIVE — module-level family handles must
        keep pointing at live, registered metrics."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            fam._zero()

    def _collected(self) -> list[dict]:
        with self._lock:
            collectors = list(self._collectors.items())
        out = []
        for _name, fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — scrape must survive one bad source
                continue
        return out

    def snapshot(self) -> dict:
        """getmetrics RPC body: every family (native + collected), with
        histogram bucket counts and p50/p90/p99 estimates inline."""
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            values = []
            for labels, child in fam.samples():
                if fam.type == "histogram":
                    values.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": round(child.sum, 9),
                        "buckets": dict(zip(
                            [str(b) for b in child.bounds] + ["+Inf"],
                            child.counts)),
                        **{k: round(v, 9)
                           for k, v in child.quantiles().items()},
                    })
                else:
                    values.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "values": values}
        for item in self._collected():
            out[item["name"]] = {
                "type": item.get("type", "gauge"),
                "help": item.get("help", ""),
                "values": [{"labels": dict(labels), "value": value}
                           for labels, value in item.get("samples", ())],
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) over every family,
        native and collected."""
        lines: list[str] = []

        def header(name, typ, help):
            if help:
                lines.append(f"# HELP {name} {_escape_help(help)}")
            lines.append(f"# TYPE {name} {typ}")

        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            header(fam.name, fam.type, fam.help)
            for labels, child in fam.samples():
                if fam.type == "histogram":
                    cum = 0
                    for b, c in zip(child.bounds, child.counts):
                        cum += c
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_label_str(labels, le=_fmt(b))} {cum}")
                    cum += child.counts[-1]
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_label_str(labels, le='+Inf')} {cum}")
                    lines.append(
                        f"{fam.name}_sum{_label_str(labels)}"
                        f" {_fmt(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{_label_str(labels)}"
                        f" {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{_label_str(labels)}"
                        f" {_fmt(child.value)}")
        for item in self._collected():
            header(item["name"], item.get("type", "gauge"),
                   item.get("help", ""))
            for labels, value in item.get("samples", ()):
                lines.append(
                    f"{item['name']}{_label_str(dict(labels))}"
                    f" {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in items.items())
    return "{" + inner + "}"


def flat_families(prefix: str, d: dict, typ: str = "gauge",
                  help: str = "") -> list[dict]:
    """Project a flat numeric dict (the shape every pre-telemetry
    snapshot() returns) into one single-sample family per key — the
    collector-side migration helper. Non-numeric values are skipped;
    nested dicts are flattened one level with ``_`` joins."""
    out = []
    for k, v in d.items():
        if isinstance(v, bool) or v is None:
            continue
        if isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, (int, float)) and not isinstance(v2, bool):
                    out.append({
                        "name": f"{prefix}_{k}_{k2}", "type": typ,
                        "help": help,
                        "samples": [({}, float(v2))],
                    })
            continue
        if isinstance(v, (int, float)):
            out.append({"name": f"{prefix}_{k}", "type": typ, "help": help,
                        "samples": [({}, float(v))]})
    return out


REGISTRY = Registry()


def counter(name, help="", labels=()) -> Family:
    return REGISTRY.counter(name, help, labels)


def gauge(name, help="", labels=()) -> Family:
    return REGISTRY.gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=None) -> Family:
    return REGISTRY.histogram(name, help, labels, buckets)


def register_collector(name: str, fn: Callable) -> None:
    REGISTRY.register_collector(name, fn)


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------

_SPANS_CAP = int(os.environ.get("BCP_TRACE_SPANS", "65536"))


class _NullSpan:
    """The no-op span returned when tracing is off — one shared instance,
    no allocation on the hot path."""

    __slots__ = ()
    corr = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "corr", "span_id", "parent",
                 "_t0")

    def __init__(self, tracer, name, args, corr, span_id, parent):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.corr = corr
        self.span_id = span_id
        self.parent = parent
        self._t0 = 0.0

    def __enter__(self):
        self._tracer._stack().append(self)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self, self._t0, t1)
        return False


class Tracer:
    """Bounded ring buffer of completed spans, Chrome-trace export.

    Correlation model: every top-level span starts a fresh correlation id;
    nested spans inherit it and link to their enclosing span via
    ``parent``. ``context()`` captures (corr, span_id) of the active span
    so work handed to another thread (the supervised-dispatch settle, a
    packer flush) can open its spans with ``parent=ctx`` and stay on the
    same correlation chain — the trace viewer stitches the block's scan
    and its device settle back together across threads."""

    def __init__(self, capacity: int = _SPANS_CAP):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._epoch = time.monotonic()
        self.recorded = 0  # total ever recorded (dropped = recorded - len)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, parent: Optional[tuple] = None, **args):
        """Context manager recording one complete ('X') span. ``parent``
        is a context() capture for cross-thread correlation; otherwise the
        enclosing span on this thread (if any) is the parent."""
        if not trace_enabled():
            return _NULL_SPAN
        sid = next(self._ids)
        if parent is not None:
            corr, parent_id = parent
        else:
            stack = self._stack()
            if stack:
                corr, parent_id = stack[-1].corr, stack[-1].span_id
            else:
                corr, parent_id = sid, None
        return _Span(self, name, args, corr, sid, parent_id)

    def context(self) -> Optional[tuple]:
        """(corr, span_id) of this thread's active span, or None — the
        cross-thread correlation handoff token."""
        if not trace_enabled():
            return None
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return (top.corr, top.span_id)

    def current_corr(self) -> Optional[int]:
        """Correlation id of the active span (the -logjson stamp)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].corr if stack else None

    def instant(self, name: str, **args) -> None:
        """One instant ('i') event — unwinds, breaker trips."""
        if not trace_enabled():
            return
        now = time.monotonic()
        ctx = self.context()
        ev = {
            "name": name, "ph": "i", "s": "t",
            "ts": round((now - self._epoch) * 1e6, 1),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": dict(args),
        }
        if ctx is not None:
            ev["args"]["corr"] = ctx[0]
        with self._lock:
            self._events.append(ev)
            self.recorded += 1

    def _record(self, span: _Span, t0: float, t1: float) -> None:
        args = dict(span.args)
        args["corr"] = span.corr
        args["span_id"] = span.span_id
        if span.parent is not None:
            args["parent"] = span.parent
        ev = {
            "name": span.name, "ph": "X",
            "ts": round((t0 - self._epoch) * 1e6, 1),
            "dur": round((t1 - t0) * 1e6, 1),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._events.append(ev)
            self.recorded += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.recorded = 0

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._events)
            recorded = self.recorded
        return {"recorded": recorded, "buffered": buffered,
                "dropped": recorded - buffered,
                "capacity": self._events.maxlen}

    def chrome_trace(self) -> dict:
        """Chrome-trace/perfetto JSON object (load at ui.perfetto.dev or
        chrome://tracing)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "bitcoincashplus-tpu telemetry"},
        }

    def dump(self, path: str) -> int:
        """Write the trace JSON; returns the number of events written."""
        trace = self.chrome_trace()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


TRACER = Tracer()


def span(name: str, parent: Optional[tuple] = None, **args):
    return TRACER.span(name, parent=parent, **args)


def trace_context() -> Optional[tuple]:
    return TRACER.context()


def current_corr() -> Optional[int]:
    return TRACER.current_corr()


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def reset() -> None:
    """Test isolation: zero every family, drop buffered spans, and
    re-read the mode from env. Families and collectors survive (module-
    level handles keep pointing at registered metrics)."""
    global _MODE
    _MODE = None
    REGISTRY.reset()
    TRACER.clear()
