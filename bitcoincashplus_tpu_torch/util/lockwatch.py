"""Runtime lock-order sentinel (a Python TSan-lite).

Env-gated: when ``BCP_LOCKWATCH=1`` the :func:`watched_lock` /
:func:`watched_rlock` / :func:`watched_condition` factories return
instrumented wrappers in place of the plain ``threading`` primitives at
the node's real lock sites (``cs_main``, sigcache, banlist, SigService,
per-shard store write locks). Each wrapper reports every *first-hold*
acquisition to the process-global :data:`MONITOR`, which keeps a
per-thread stack of currently-held locks and folds each acquisition into
a directed lock-order graph: an edge ``A -> B`` means some thread
acquired ``B`` while holding ``A``. A cycle in that graph is a latent
deadlock — two code paths that take the same locks in opposite orders —
even if the schedules never actually collided during the run (the same
happens-before generalization TSan applies to data races).

When the gate is off the factories return the plain primitive: zero
wrapper frames, zero bookkeeping, nothing to reason about in production.

Findings surface three ways: the :func:`snapshot` feed behind
``gettpuinfo``'s ``lockwatch`` section, the node's ``lockwatch``
telemetry collector, and an atexit report on stderr (tier-1 functional
nodes run with the gate on, so an inversion introduced by a patch fails
the suite loudly instead of waiting for the unlucky schedule).

Static extraction of the same ordering lives in bcplint's BCP004; this
module is the runtime half that sees through indirection the AST can't.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading

_ENV_GATE = "BCP_LOCKWATCH"


def enabled() -> bool:
    """True when the sentinel gate is set (checked per factory call, so a
    test can flip the env var before constructing a node)."""
    return os.environ.get(_ENV_GATE, "") not in ("", "0")


class _ThreadState(threading.local):
    def __init__(self):
        self.stack = []   # lock names, first-hold acquisition order
        self.counts = {}  # name -> recursion depth (RLock re-entry)


class LockMonitor:
    """Process-global acquisition-order graph.

    Edges are recorded on the *first* hold of a lock by a thread
    (re-entrant RLock acquires add depth, never edges, so ``cs_main``
    recursion cannot self-cycle). Release order is free to differ from
    acquisition order — the stack is a held-set with stable insertion
    order, not a strict LIFO.
    """

    def __init__(self):
        self._mu = threading.Lock()  # guards the shared graph/counters
        self._tls = _ThreadState()
        self.names: set[str] = set()
        self.acquisitions: dict[str, int] = {}
        self.max_depth = 0
        # (held, acquired) -> times observed; first-seen code site kept
        # separately so the cycle report can say WHERE each leg happened
        self.edges: dict[tuple[str, str], int] = {}
        self.edge_sites: dict[tuple[str, str], str] = {}
        # GUARDED_BY vocabulary: lock name -> sorted fields declared
        # guarded by it (bcplint BCP009's annotation convention), so the
        # runtime snapshot and the static concurrency report agree on
        # which locks are annotation-declared vs merely inferred
        self.declared_guards: dict[str, list[str]] = {}

    def declare_guards(self, lock_name: str, fields) -> None:
        with self._mu:
            cur = set(self.declared_guards.get(lock_name, ()))
            cur.update(fields)
            self.declared_guards[lock_name] = sorted(cur)

    # -- registration ---------------------------------------------------

    def register(self, name: str) -> None:
        with self._mu:
            self.names.add(name)
            self.acquisitions.setdefault(name, 0)

    # -- acquisition bookkeeping (called by WatchedLock only) -----------

    @staticmethod
    def _call_site() -> str:
        # first frame outside this module = the real acquire site
        f = sys._getframe(2)
        here = __file__
        while f is not None and f.f_code.co_filename == here:
            f = f.f_back
        if f is None:
            return "?"
        return "%s:%d" % (os.path.basename(f.f_code.co_filename), f.f_lineno)

    def on_acquire(self, name: str) -> None:
        st = self._tls
        if st.counts.get(name, 0):
            st.counts[name] += 1  # re-entrant: depth only, no edges
            return
        # resolve the code site before taking _mu, and only when this
        # acquisition can mint edges (a held stack exists)
        site = self._call_site() if st.stack else None
        held = tuple(st.stack)
        st.stack.append(name)
        st.counts[name] = 1
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            if len(st.stack) > self.max_depth:
                self.max_depth = len(st.stack)
            for h in held:
                if h == name:
                    continue
                key = (h, name)
                if key not in self.edges:
                    self.edges[key] = 0
                    self.edge_sites[key] = site or "?"
                self.edges[key] += 1

    def on_release(self, name: str) -> None:
        st = self._tls
        n = st.counts.get(name, 0)
        if n > 1:
            st.counts[name] = n - 1
            return
        if n == 1:
            del st.counts[name]
            st.stack.remove(name)

    def on_release_all(self, name: str) -> int:
        """Condition.wait() path: drop every recursion level at once.
        Returns the depth so the restore can reinstate it."""
        st = self._tls
        n = st.counts.pop(name, 0)
        if n:
            st.stack.remove(name)
        return n

    def on_acquire_restore(self, name: str, depth: int) -> None:
        self.on_acquire(name)
        self._tls.counts[name] = max(depth, 1)

    # -- reporting ------------------------------------------------------

    def cycles(self) -> list[dict]:
        """Strongly-connected components of the order graph with more
        than one lock (or a self-loop): each is a lock-order inversion.
        Returns ``[{"locks": [...], "edges": {"a->b": "file:line"}}]``."""
        with self._mu:
            edges = dict(self.edges)
            sites = dict(self.edge_sites)
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        # iterative Tarjan SCC
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        for root in adj:
            if root in index:
                continue
            work = [(root, 0)]
            while work:
                node, i = work.pop()
                if i == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                succs = adj[node]
                while i < len(succs):
                    w = succs[i]
                    i += 1
                    if w not in index:
                        work.append((node, i))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        out = []
        for scc in sccs:
            members = set(scc)
            if len(scc) < 2 and not any((n, n) in edges for n in scc):
                continue
            cyc_edges = {
                "%s->%s" % (a, b): sites[(a, b)]
                for (a, b) in edges
                if a in members and b in members
            }
            out.append({"locks": sorted(members), "edges": cyc_edges})
        return out

    def snapshot(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            acq = dict(self.acquisitions)
            return {
                "enabled": True,
                "locks": sorted(self.names),
                "acquisitions": acq,
                "acquisitions_total": sum(acq.values()),
                "max_depth": self.max_depth,
                "order_edges": {
                    "%s->%s" % k: n for k, n in sorted(self.edges.items())
                },
                "inversions": len(cycles),
                "cycles": cycles,
                "declared_guards": {
                    k: list(v)
                    for k, v in sorted(self.declared_guards.items())
                },
            }

    def reset(self) -> None:
        """Test hook: drop the graph (thread-local stacks of live threads
        are left alone — callers reset between quiescent phases)."""
        with self._mu:
            self.names.clear()
            self.acquisitions.clear()
            self.edges.clear()
            self.edge_sites.clear()
            self.declared_guards.clear()
            self.max_depth = 0


MONITOR = LockMonitor()


class WatchedLock:
    """Instrumented wrapper over a ``threading`` Lock/RLock.

    Implements the full ``Condition`` lock duck-type — ``_release_save``
    / ``_acquire_restore`` / ``_is_owned`` — so a ``Condition`` built
    over a watched lock keeps correct wait() semantics AND correct
    held-stack bookkeeping across the wait's release/reacquire.
    """

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        MONITOR.register(name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            MONITOR.on_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        MONITOR.on_release(self.name)

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # -- Condition protocol --------------------------------------------

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()  # RLock: full recursive release
        else:
            inner.release()
            state = None
        return (state, MONITOR.on_release_all(self.name))

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        MONITOR.on_acquire_restore(self.name, depth)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # plain-Lock heuristic (threading.Condition's own): bypasses the
        # wrapper deliberately so the probe never touches the bookkeeping
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return "<WatchedLock %s over %r>" % (self.name, self._inner)


_exit_hooked = False


def _hook_exit_report() -> None:
    global _exit_hooked
    if _exit_hooked:
        return
    _exit_hooked = True
    atexit.register(_exit_report)


def _exit_report() -> None:
    snap = MONITOR.snapshot()
    if not snap["acquisitions_total"]:
        return
    line = ("bcp-lockwatch: %d locks, %d acquisitions, max depth %d, "
            "%d inversion(s)\n" % (len(snap["locks"]),
                                   snap["acquisitions_total"],
                                   snap["max_depth"], snap["inversions"]))
    sys.stderr.write(line)
    for cyc in snap["cycles"]:
        sys.stderr.write("bcp-lockwatch: CYCLE %s\n" % " <-> ".join(
            cyc["locks"]))
        for edge, site in sorted(cyc["edges"].items()):
            sys.stderr.write("bcp-lockwatch:   %s at %s\n" % (edge, site))
    sys.stderr.flush()


def watched_lock(name: str, inner=None):
    """A ``threading.Lock`` (or the supplied inner lock), wrapped when
    the sentinel gate is on; the plain primitive otherwise."""
    if inner is None:
        inner = threading.Lock()
    if not enabled():
        return inner
    _hook_exit_report()
    return WatchedLock(name, inner)


def watched_rlock(name: str):
    if not enabled():
        return threading.RLock()
    _hook_exit_report()
    return WatchedLock(name, threading.RLock())


def watched_condition(name: str):
    """A ``threading.Condition`` whose underlying lock is watched (the
    cv's lock participates in the order graph like any other lock)."""
    return threading.Condition(watched_lock(name))


def declare_guards(lock_name: str, fields) -> None:
    """Record the GUARDED_BY vocabulary for ``lock_name`` — called by
    classes adopting bcplint's BCP009 annotation so gettpuinfo reports
    which locks are declared guards (vs inferred from order edges)."""
    MONITOR.declare_guards(lock_name, fields)


def snapshot() -> dict:
    """gettpuinfo's ``lockwatch`` section."""
    if not enabled():
        return {"enabled": False}
    return MONITOR.snapshot()
