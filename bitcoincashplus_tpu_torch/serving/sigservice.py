"""SigService — a persistent, deadline-driven micro-batching signature
verification service for the live-traffic hot path.

The IBD graft (ops/ecdsa_batch.LanePacker) batches signatures across
in-flight *blocks*; a node serving heavy live traffic is instead
dominated by mempool ingest and tip relay, where work arrives as a
stream of single transactions. This service is the always-on analogue:
callers (mempool/accept.verify_tx_scripts, compact-block reconstruction,
getblocktemplate proposal re-validation) enqueue per-input
SigCheckRecords into a shared lane buffer and await per-tx futures; a
dedicated service thread flushes lanes into ops/ecdsa_batch dispatches.

Flush policy — a bucket flush fires on the FIRST of:
  * full      — pending lanes reached the bucket target (-sigservicelanes)
  * deadline  — the oldest pending lane aged past -sigservicedeadline,
                so a lone transaction never starves waiting for peers
  * kick      — a caller blocked in TxSigFuture.result() with lanes still
                parked; batching only ever helps *concurrent* callers, so
                a blocked waiter flushes immediately rather than paying
                the deadline for nothing
  * stop      — service shutdown drains whatever is pending

Sigcache awareness: records whose (sighash, r, s, pubkey) key is already
cached never occupy a lane (the future resolves them to True inline), and
identical records submitted concurrently share ONE lane (in-flight dedup
by key — a relay storm delivering the same signature through several
paths verifies it once). Settled TRUE verdicts are inserted into the
shared SignatureCache at settle time, so service-verified mempool inputs
are cache hits for the eventual block connect — exactly what the
synchronous path guaranteed.

Degradation: every flush goes through ecdsa_batch.dispatch_batch, i.e.
the supervised device-decompose -> host-decompose -> w4 -> XLA -> CPU
chain with breaker/KAT gating. A flush that raises anyway resolves the
affected lanes to an error state and TxSigFuture.result() re-verifies
those records on the CPU oracle — the verdict a caller sees is never
dropped or fabricated, and ``-sigservice=off`` is byte-identical by
construction (the callers run the unchanged synchronous path). A kernel
that cannot be built or launched (KernelUnavailable) is not degraded: it
raises to every waiter of the flush, and the service thread dies with it.

Since ISSUE 11 the GLV lattice split rides the device program, so the
host half of a flush (_dispatch_flush) is numpy byte emission only: with
``-sigservicebuffers`` >= 2 the residual emit of flush N+1 overlaps the
device decompose+verify of flush N. (The BENCH_r11 re-measure of the
closed-loop ``concurrent`` level still favors sync — 0.33x — which
rules pack cost OUT as the cause: bounded concurrency simply cannot
fill buckets, so the batching tax is structural there, not a host leg.)

Block-import priority: while a block is being connected
(ChainstateManager wraps process_new_block* in ``import_priority()``),
mempool flushes dispatch on the CPU lane so the settle horizon keeps the
device to itself.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np

from ..ops import ecdsa_batch
from ..util import devicewatch as dw
from ..util import lockwatch
from ..util import telemetry as tm
from ..util.log import log_printf
from ..validation.sigcache import SignatureCache

# Flush-policy defaults: 2046 lanes fill the 2048 compiled bucket exactly
# once the supervised dispatch appends its 2 known-answer lanes (the same
# sizing as LanePacker); 4 ms keeps a lone tx's worst-case added latency
# well under any human-visible budget while still letting a burst batch.
DEFAULT_LANES = 2046
DEFAULT_DEADLINE_MS = 4.0
# TxSigFuture.result() safety net: if the service thread is wedged past
# this, the caller re-verifies its own records on the CPU oracle.
RESULT_TIMEOUT_S = 30.0

FLUSH_REASONS = ("full", "deadline", "kick", "stop")

# -- telemetry families (util/telemetry) --------------------------------
_QUEUE_G = tm.gauge(
    "bcp_sigservice_queue_depth",
    "Signature lanes parked in the SigService pending buffer")
_FLUSH_C = tm.counter(
    "bcp_sigservice_flush_total",
    "SigService bucket flushes by firing policy",
    labels=("reason",))
_FLUSH_LANES_H = tm.histogram(
    "bcp_sigservice_flush_lanes",
    "Real lanes per SigService flush",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 512, 1024, 2046, 4096))
_WAIT_H = tm.histogram(
    "bcp_sigservice_wait_seconds",
    "Enqueue -> settled verdict latency per lane",
    buckets=(0.0005, 0.001, 0.002, 0.004, 0.008, 0.016, 0.032, 0.064,
             0.128, 0.25, 0.5, 1.0, 5.0))
_MISS_C = tm.counter(
    "bcp_sigservice_deadline_miss_total",
    "Flushes that fired later than 2x the configured deadline")


class _Lane:
    """One pending signature check: the record, its sigcache key, and the
    settle verdict every subscribed future shares. The rendezvous is the
    SERVICE's condition variable (one notify_all per flush), not a
    per-lane Event — Event allocation alone cost ~12 µs/lane, which at
    storm rates was a double-digit share of the whole submit path."""

    __slots__ = ("record", "key", "t_enqueue", "ctx", "ok", "err")

    def __init__(self, record, key: bytes, ctx):
        self.record = record
        self.key = key
        self.t_enqueue = time.monotonic()
        self.ctx = ctx  # enqueue-side trace context (flush span parent)
        self.ok: Optional[bool] = None
        self.err: Optional[BaseException] = None

    def settled(self) -> bool:
        return self.ok is not None or self.err is not None


class TxSigFuture:
    """One caller's slice of the shared lanes. ``sources`` holds, per
    submitted record in order: True (pre-settled — sigcache hit) or a
    _Lane (possibly shared with other futures via in-flight dedup)."""

    __slots__ = ("_service", "_sources")

    def __init__(self, service: "SigService", sources: list):
        self._service = service
        self._sources = sources

    def done(self) -> bool:
        return all(s is True or s.settled() for s in self._sources)

    def wait(self, timeout: float) -> bool:
        """Advisory barrier: kick, then block until every lane settles or
        ``timeout`` elapses; returns whether everything settled. Never
        re-verifies anything itself — callers that only want the settle
        side effects (prewarm_block_sigs warming the sigcache) use this
        instead of result(), so a backlogged service costs them at most
        the timeout, never a serial CPU re-verify under their locks (the
        service still settles the lanes later and the cache still fills)."""
        lanes = [s for s in self._sources if s is not True]
        if not any(not lane.settled() for lane in lanes):
            return True
        self._service.kick()
        deadline = time.monotonic() + timeout
        cond = self._service._cond
        with cond:
            while any(not lane.settled() for lane in lanes):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                cond.wait(remaining)
        return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until every lane settles; returns a bool verdict per
        record in submission order. Kicks the service first — a blocked
        waiter must never sit out the deadline when nothing else is
        coming.

        Lanes that timed out or errored are re-verified on the CPU
        oracle by THIS thread (the verdict is never dropped or
        fabricated) — in ONE batched call, with the sigcache consulted
        first and TRUE verdicts inserted after, so futures sharing a
        deduped errored lane pay the re-verify once between them and the
        eventual block connect still gets its cache hit. A lane whose
        flush met a kernel that cannot be built or launched
        (KernelUnavailable) raises it here instead: that is never
        degraded to the CPU."""
        if timeout is None:
            timeout = self._service.result_timeout
        self.wait(timeout)
        out = np.empty(len(self._sources), dtype=bool)
        unresolved: list[tuple[int, _Lane]] = []
        for i, src in enumerate(self._sources):
            if src is True:
                out[i] = True
            elif isinstance(src.err, ecdsa_batch.KernelUnavailable):
                raise src.err  # a missing kernel surfaces, not degrades
            elif src.err is not None or not src.settled():
                if not src.settled():
                    self._service._note_timeout()
                unresolved.append((i, src))
            else:
                out[i] = bool(src.ok)
        if unresolved:
            svc = self._service
            todo: list[tuple[int, _Lane]] = []
            for i, src in unresolved:
                if svc.sigcache is not None and svc.sigcache.contains(
                        src.key):
                    out[i] = True  # another waiter already re-verified it
                else:
                    todo.append((i, src))
            if todo:
                ok = ecdsa_batch.verify_batch(
                    [src.record for _, src in todo], backend="cpu")
                for (i, src), good in zip(todo, ok):
                    out[i] = bool(good)
                    if good and svc.sigcache is not None:
                        svc.sigcache.add(src.key)
        return out


class SigService:
    """The always-on micro-batching verify loop (module docstring)."""

    def __init__(self, sigcache: Optional[SignatureCache] = None,
                 backend: str = "auto", kernel: Optional[str] = None,
                 deadline_ms: float = DEFAULT_DEADLINE_MS,
                 lanes: int = DEFAULT_LANES,
                 watchdog_quiet: Optional[float] = None,
                 buffers: int = 2):
        if deadline_ms < 0:
            raise ValueError(
                f"-sigservicedeadline={deadline_ms}: must be >= 0")
        if lanes < 1:
            raise ValueError(f"-sigservicelanes={lanes}: must be >= 1")
        if buffers < 1:
            raise ValueError(f"-sigservicebuffers={buffers}: must be >= 1")
        self.sigcache = sigcache
        self.backend = backend
        self.kernel = kernel
        self.deadline_s = deadline_ms / 1e3
        self.lanes = lanes
        # stall-watchdog quiet period (util/devicewatch; -watchdogquiet):
        # None = env/default, <= 0 = detection off for this subsystem
        self.watchdog_quiet = watchdog_quiet
        self.result_timeout = RESULT_TIMEOUT_S
        # flush double-buffering (-sigservicebuffers, ISSUE 9 / ROADMAP
        # PR 7 headroom): up to ``buffers`` dispatched-but-unsettled
        # flushes ride concurrently, so the host packs flush N+1 while
        # the device verifies flush N. 1 = the PR 7 single-slot loop.
        self.buffers = buffers
        # condition over a (possibly lockwatch-watched) lock: submitters,
        # the flush thread, and settle callbacks all rendezvous here
        self._cond = lockwatch.watched_condition("sigservice_cond")
        self._pending: list[_Lane] = []
        self._by_key: dict[bytes, _Lane] = {}  # pending + in-flight lanes
        self._inflight: list[dict] = []  # dispatched, unsettled flushes
        self._kick = False
        self._stop = False
        self._priority = 0  # block-import preemption depth (re-entrant)
        self._thread: Optional[threading.Thread] = None
        self.stats = {
            "submits": 0, "lanes_enqueued": 0, "cache_hits": 0,
            "dedup_hits": 0, "dispatches": 0, "lanes_real": 0,
            "flush_full": 0, "flush_deadline": 0, "flush_kick": 0,
            "flush_stop": 0, "preempted_dispatches": 0,
            "deadline_misses": 0, "timeouts": 0, "flush_errors": 0,
            "prewarm_txs": 0, "prewarm_records": 0,
            "overlapped_flushes": 0,
        }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "SigService":
        self._thread = threading.Thread(
            target=self._run, name="sigservice", daemon=True)
        self._thread.start()
        # no-progress sentinel (observe-only): pending lanes with no
        # flush completion for the quiet period = a wedged flush thread
        # (len() is GIL-atomic — the probe must never take the condvar)
        dw.WATCHDOG.register("sigservice",
                             pending_fn=lambda: len(self._pending),
                             quiet_s=self.watchdog_quiet)
        return self

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        """Drain pending lanes (reason 'stop') and join the thread."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=self.result_timeout)
            self._thread = None
        dw.WATCHDOG.unregister("sigservice")

    # -- enqueue side ---------------------------------------------------

    def submit(self, records: Sequence, keys: Optional[Sequence[bytes]]
               = None) -> TxSigFuture:
        """Enqueue one transaction's fresh sigcheck records; returns the
        per-tx future. Sigcache hits and in-flight duplicates never
        occupy a lane."""
        if keys is None:
            keys = [SignatureCache.entry_key(
                        r.msg_hash, r.r, r.s, r.pubkey,
                        getattr(r, "algo", "ecdsa"))
                    for r in records]
        ctx = tm.trace_context()
        sources: list = []
        fresh = 0
        with self._cond:
            st = self.stats
            st["submits"] += 1
            for rec, key in zip(records, keys):
                if self.sigcache is not None and self.sigcache.contains(key):
                    st["cache_hits"] += 1
                    sources.append(True)
                    continue
                lane = self._by_key.get(key)
                if lane is not None:
                    st["dedup_hits"] += 1
                    if self.sigcache is not None:
                        self.sigcache.note_dedup()
                    sources.append(lane)
                    continue
                lane = _Lane(rec, key, ctx)
                self._by_key[key] = lane
                self._pending.append(lane)
                sources.append(lane)
                fresh += 1
            st["lanes_enqueued"] += fresh
            _QUEUE_G.set(len(self._pending))
            if fresh:
                # always wake the loop: a first lane re-arms the deadline
                # timer (the thread may be parked in an unbounded wait)
                self._cond.notify_all()
        if fresh and not self.running():
            # no service thread (stopped, or it died on a programming
            # error): the flush runs inline on the caller — synchronous,
            # but never stranded
            self._flush_once("kick")
        return TxSigFuture(self, sources)

    def kick(self) -> None:
        """Request an immediate flush (a caller is blocked on a verdict)."""
        with self._cond:
            if not self._pending:
                return
            self._kick = True
            self._cond.notify_all()
        if not self.running():
            self._flush_once("kick")

    def _note_timeout(self) -> None:
        with self._cond:
            self.stats["timeouts"] += 1

    @contextmanager
    def import_priority(self):
        """Block-import preemption: while held, flushes dispatch on the
        CPU lane so the settle horizon keeps the device lanes. Re-entrant
        (nested block connects during a reorg)."""
        with self._cond:
            self._priority += 1
        try:
            yield
        finally:
            with self._cond:
                self._priority -= 1

    # -- service loop ---------------------------------------------------

    def _flush_reason_locked(self) -> Optional[str]:
        if not self._pending:
            self._kick = False  # nothing to kick for
            return None
        if self._stop:
            return "stop"
        if len(self._pending) >= self.lanes:
            return "full"
        if self._kick:
            return "kick"
        age = time.monotonic() - self._pending[0].t_enqueue
        if age >= self.deadline_s:
            return "deadline"
        return None

    def _run(self) -> None:
        try:
            while True:
                settle_now = None
                with self._cond:
                    while True:
                        reason = self._flush_reason_locked()
                        if (reason is not None
                                and len(self._inflight) < self.buffers):
                            break  # a slot is free: go pack + dispatch
                        if self._inflight:
                            # nothing new to pack (or slots full): settle
                            # the OLDEST in-flight flush — its device work
                            # has had the whole pack window to run
                            settle_now = self._inflight.pop(0)
                            break
                        if self._stop:
                            return  # drained: exit
                        timeout = None
                        if self._pending:
                            age = (time.monotonic()
                                   - self._pending[0].t_enqueue)
                            timeout = max(0.0, self.deadline_s - age)
                        self._cond.wait(timeout)
                if settle_now is not None:
                    self._settle_flush(settle_now)
                    continue
                ent = self._dispatch_flush(reason)
                if ent is not None:
                    if self._inflight:
                        # flush N is still on the device while N+1's host
                        # pack just ran — the double-buffer overlap
                        self.stats["overlapped_flushes"] += 1
                    self._inflight.append(ent)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — visible death, below
            # _settle_flush re-raises programming errors AFTER resolving
            # the affected lanes; the thread dies loudly and later
            # submits/kicks run their flushes inline on the caller.
            # Any OTHER in-flight flush's lanes resolve to the same error
            # NOW — waiters must fail fast to their CPU re-verify (or, for
            # a KernelUnavailable, raise it), not sit out the full result
            # timeout on a dead thread.
            with self._cond:
                for ent in self._inflight:
                    for lane in ent["batch"]:
                        if not lane.settled():
                            lane.err = e
                        self._by_key.pop(lane.key, None)
                self._inflight.clear()
                if isinstance(e, ecdsa_batch.KernelUnavailable):
                    # lanes still queued behind the failed flush carry it
                    # too, and running() is False from here, so a later
                    # submit flushes inline and raises it
                    for lane in self._pending:
                        lane.err = e
                        self._by_key.pop(lane.key, None)
                    self._pending.clear()
                    _QUEUE_G.set(0)
                    self._thread = None
                self._cond.notify_all()
            log_printf("sigservice thread died: %s: %s — submissions "
                       "degrade to inline synchronous dispatch",
                       type(e).__name__, str(e)[:200])

    def _flush_once(self, reason: str) -> None:
        """Pack, dispatch, settle and fulfill ONE bucket synchronously —
        the inline path for callers whose service thread is stopped or
        dead (the thread itself runs the split _dispatch_flush /
        _settle_flush pair through the double-buffer loop)."""
        ent = self._dispatch_flush(reason)
        if ent is not None:
            self._settle_flush(ent)

    def _dispatch_flush(self, reason: str) -> Optional[dict]:
        """The HOST half of a flush: take one bucket off the pending
        buffer, pack, and enqueue the supervised dispatch. The device
        (on an async backend) verifies in the background; the verdict
        wait and lane fulfillment happen in _settle_flush. Returns the
        in-flight entry, or None when nothing was pending."""
        with self._cond:
            if not self._pending:
                return None
            # always cap a flush at the bucket target: an overload burst
            # must not compile a one-off giant bucket — it drains as a
            # train of full buckets (the loop re-fires immediately)
            take = min(len(self._pending), self.lanes)
            batch = self._pending[:take]
            del self._pending[:take]
            if reason in ("kick", "stop"):
                self._kick = False
            st = self.stats
            st[f"flush_{reason}"] = st.get(f"flush_{reason}", 0) + 1
            st["dispatches"] += 1
            st["lanes_real"] += len(batch)
            preempted = self._priority > 0
            if preempted:
                st["preempted_dispatches"] += 1
            age = time.monotonic() - batch[0].t_enqueue
            missed = (self.deadline_s > 0
                      and age > 2.0 * self.deadline_s
                      and reason in ("deadline", "stop"))
            if missed:
                st["deadline_misses"] += 1
            _QUEUE_G.set(len(self._pending))
        _FLUSH_C.labels(reason=reason).inc()
        _FLUSH_LANES_H.observe(len(batch))
        if missed:
            _MISS_C.inc()
            tm.instant("serving.deadline_miss",
                       age_ms=round(age * 1e3, 3),
                       deadline_ms=round(self.deadline_s * 1e3, 3),
                       lanes=len(batch))
        backend = "cpu" if preempted else self.backend
        records = [lane.record for lane in batch]
        handle = err = None
        ctx = None
        with tm.span("serving.flush", parent=batch[0].ctx, reason=reason,
                     lanes=len(batch)):
            # the settle span (possibly on a later loop iteration) chains
            # off this flush span — the same flush->settle structure
            # trace_view reads, just no longer forced to nest in time
            ctx = tm.trace_context()
            try:
                handle = ecdsa_batch.dispatch_batch(
                    records, backend=backend, kernel=self.kernel)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — resolved at settle
                err = e
        return {"batch": batch, "handle": handle, "err": err, "ctx": ctx}

    def _settle_flush(self, ent: dict) -> None:
        """The SETTLE half: block on the dispatch's verdict, fulfill the
        lanes, and broadcast ONCE on the service condvar (the PR 7
        single-notify rendezvous — per-lane Events were the submit-path
        cost the service was built to avoid)."""
        batch = ent["batch"]
        ok, err = None, ent["err"]
        if err is None:
            with tm.span("serving.settle", parent=ent["ctx"],
                         lanes=len(batch)):
                try:
                    ok = ent["handle"].result()
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 — waiters parked
                    err = e
        now = time.monotonic()
        with self._cond:
            for i, lane in enumerate(batch):
                if ok is not None:
                    lane.ok = bool(ok[i])
                    if lane.ok and self.sigcache is not None:
                        # settle-side sigcache population: service-verified
                        # inputs must be cache hits for the eventual block
                        # connect, exactly like the synchronous path
                        self.sigcache.add(lane.key)
                else:
                    lane.err = err
                self._by_key.pop(lane.key, None)
                _WAIT_H.observe(now - lane.t_enqueue)
            if err is not None:
                self.stats["flush_errors"] += 1
            self._cond.notify_all()  # one settle broadcast per flush
        # progress beat even on an errored flush: the lanes were resolved
        # (to err) and the thread is demonstrably still draining work —
        # the watchdog watches for NO progress, not for failures
        dw.WATCHDOG.beat("sigservice")
        if err is not None:
            log_printf("sigservice flush failed (%s: %s) — %d lane(s) "
                       "degrade to caller-side CPU re-verify",
                       type(err).__name__, str(err)[:160], len(batch))
            if isinstance(err, (NameError, AttributeError,
                                UnboundLocalError,
                                ecdsa_batch.KernelUnavailable)):
                raise err  # programming errors, missing kernel surface

    # -- observability --------------------------------------------------

    def snapshot(self) -> dict:
        """gettpuinfo's ``serving`` section."""
        with self._cond:
            out = dict(self.stats)
            out["queue_depth"] = len(self._pending)
            out["inflight_keys"] = len(self._by_key)
            out["inflight_flushes"] = len(self._inflight)
            out["priority_depth"] = self._priority
        out["enabled"] = True
        out["buffers"] = self.buffers
        out["running"] = self.running()
        out["backend"] = self.backend
        # which decompose the GLV flushes ride (ISSUE 11): "device" =
        # the fused in-kernel lattice split, "host" = the numpy-batch
        # fallback, "n/a" = a non-GLV kernel is selected
        from ..ops import ecdsa_batch as _eb

        out["glv_decompose"] = (
            "n/a" if (self.kernel or _eb.active_kernel()) != "glv"
            else ("device" if _eb.glv_dev_enabled() else "host"))
        out["deadline_ms"] = round(self.deadline_s * 1e3, 3)
        out["lanes"] = self.lanes
        out["wait_ms"] = {
            k: round(v * 1e3, 3)
            for k, v in _WAIT_H.quantiles((0.5, 0.9, 0.99)).items()
        }
        out["watchdog"] = dw.WATCHDOG.snapshot().get("sigservice", {})
        return out


# ---------------------------------------------------------------------------
# Tip-relay prewarm: feed a reconstructed/proposed block's non-mempool
# transactions through the service so the imminent connect's sigcache
# probe hits instead of re-verifying inline.
# ---------------------------------------------------------------------------


def prewarm_block_sigs(node, block, timeout: float = 2.0,
                       require_pow: bool = True) -> int:
    """Scan ``block``'s transactions that are NOT in the mempool, defer
    their sigchecks, and settle them through the node's SigService so
    the block connect that follows finds the verdicts in the sigcache.

    Caller holds cs_main. Purely advisory: any scan failure, missing
    input, or service hiccup just skips the transaction — the block
    connect remains the authoritative verdict (an invalid signature is
    simply never inserted into the cache, so nothing can be masked).
    Returns the number of records enqueued.

    Gate order is cost order: the cheap tip-extension/mempool checks
    bail first (IBD never pays anything here), then — P2P callers only
    (``require_pow``) — the header must carry REAL proof of work, and
    the merkle root must commit to the body. Without the PoW gate an
    unsolicited garbage block whose merkle root merely matches its own
    body (free to construct) would buy a full interpreter pass under
    cs_main before the connect rejects it. getblocktemplate proposal
    mode passes require_pow=False: proposals are legitimately unmined,
    and the RPC surface is local/authenticated."""
    svc = getattr(node, "sigservice", None)
    if svc is None or not block.vtx:
        return 0
    cs = node.chainstate
    # tip-relay gate: prewarm pays a second interpreter pass over the
    # non-mempool txs, which only wins when the block is a live tip
    # extension with a populated mempool (during IBD every tx would be
    # scanned twice for nothing)
    if (block.header.hash_prev_block != cs.tip().hash
            or not len(node.mempool.entries)):
        return 0
    if require_pow:
        from ..consensus.pow import check_proof_of_work

        if not check_proof_of_work(block.header.get_hash(),
                                   block.header.bits, cs.params.consensus):
            return 0
    from ..consensus.merkle import block_merkle_root

    root, mutated = block_merkle_root(block)
    if root != block.header.hash_merkle_root or mutated:
        return 0  # body does not match the committed root
    from ..script.interpreter import (
        SCRIPT_VERIFY_NULLFAIL,
        DeferringSignatureChecker,
        ScriptError,
        VerifyScript,
    )
    from ..script.sighash import SighashCache
    from ..validation.scriptcheck import block_script_flags

    prev = cs.block_index.get(block.header.hash_prev_block)
    height = (prev.height + 1) if prev is not None else cs.tip().height + 1
    flags = block_script_flags(height, block.header.time, cs.params)
    if not flags & SCRIPT_VERIFY_NULLFAIL:
        return 0  # pre-NULLFAIL era: deferral unsound
    in_block: dict[bytes, object] = {tx.txid: tx for tx in block.vtx}
    records: list = []
    n_txs = 0
    for tx in block.vtx[1:]:
        if tx.txid in node.mempool.entries:
            continue  # verified at accept; sigcache already has it
        tx_records: list = []
        cache = SighashCache(tx)
        try:
            for i, txin in enumerate(tx.vin):
                parent = in_block.get(txin.prevout.hash)
                if parent is not None:
                    out = parent.vout[txin.prevout.n]
                    value, spk = out.value, out.script_pubkey
                else:
                    coin = cs.coins.get_coin(txin.prevout)
                    if coin is None:
                        out = node.mempool.get_output(txin.prevout)
                        if out is None:
                            raise LookupError("missing input")
                        value, spk = out.value, out.script_pubkey
                    else:
                        value, spk = coin.out.value, coin.out.script_pubkey
                checker = DeferringSignatureChecker(
                    tx, i, value, tx_records, cache)
                VerifyScript(txin.script_sig, spk, flags, checker)
        except (KeyboardInterrupt, SystemExit):
            raise
        except (ScriptError, LookupError, IndexError, ValueError):
            continue  # connect gives the authoritative verdict
        records.extend(tx_records)
        n_txs += 1
    if not records:
        return 0
    with svc._cond:
        svc.stats["prewarm_txs"] += n_txs
        svc.stats["prewarm_records"] += len(records)
    try:
        # advisory wait, NOT result(): a backlogged service must cost the
        # relay path at most ``timeout`` — late settles still warm the
        # sigcache, and the connect re-verifies whatever missed it
        svc.submit(records).wait(timeout)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:  # noqa: BLE001 — advisory path
        pass
    return len(records)
