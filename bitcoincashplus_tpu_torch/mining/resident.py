"""Device-resident mining loop.

Port of the reference's mining/resident.py. The per-call sweep
(``ops/miner.sweep_header``) pays, on every call: staging the template, a
launch, a blocking result read and the supervision bookkeeping —
serially, with the device idle between calls. ``ResidentSweep`` keeps
the sweep resident instead:

- **One kernel, one launch shape, swapped templates.** The template
  (the hoisted (64,) words of ops/sha256_sweep and, for the exact kernel,
  the (8,) target limbs) lives in device tensors; a template refresh
  (``set_template``) makes new tensors of the same shapes from pinned
  host memory on the loop's stream and bumps the generation — the same
  kernel and launch shape serve every template, declared to devicewatch
  as the ``miner_resident`` program with a shape budget that a swap must
  not grow. (The template is a device buffer, not a launch argument: the
  kernel entries take tensors, and a CPU tensor selects the plain
  version.) Each in-flight segment keeps references to the buffers it
  was launched with, and every launch, copy and allocation of the loop
  runs on its one stream, so no segment reads a swapped buffer.
- **Pipelined segments on one CUDA stream.** The nonce space is swept in
  fixed-size segments (``seg_tiles`` tiles a launch); up to ``inflight``
  segments are queued at once. Each segment's (found, nonce, tiles) goes
  from a small device tensor into pinned host memory by an asynchronous
  copy, followed by a ``torch.cuda.Event``; the host polls the oldest
  segment with ``event.query()`` and waits on the event only when it has
  not settled yet, while the next segment already runs.
- **Nonce-space rollover.** The host cursor clamps each segment at the
  2^32 boundary (``ops/miner._boundary_tiles``) and wraps to 0, counting
  passes — a sweep crossing the boundary continues at nonce 0 without
  re-hashing the straddled range.
- **Candidate-hit FIFO.** Device hits are host exact-verified (the
  scalar oracle — 2 hashes) and pushed into a bounded FIFO the caller
  polls; with the h7 kernel a false positive (limb7 tie, ~2^-32) is
  resumed past synchronously, so results stay bit-identical to the CPU
  oracle.

On the CPU device (the tests) the segments run synchronously on the
plain versions; with ``cuda`` selected and no card, ``set_template``
raises ``KernelUnavailable``.

``sweep()`` adapts the loop to the ``sweep_header`` contract (first hit
in nonce order wins, ``(nonce | None, hashes_attempted)``) so
``mining/generate.mine_block`` drives the persistent loop through
``ops/dispatch.supervised_resident_sweep``: an injected device fault
(``BCP_FAULT_*``) degrades to the scalar host loop under the miner
breaker, any other failure raises ``KernelUnavailable``, and every
settle beats the ``miner`` watchdog subsystem.

Telemetry: the reference's ``bcp_mining_*`` counter/histogram families;
``snapshot()`` keeps the reference's keys.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch

from ..crypto.hashes import sha256d
from ..ops.cuda_build import require_device
from ..ops.miner import _boundary_tiles, sweep, target_tensor
from ..ops.sha256 import target_to_limbs_np
from ..ops.sha256_sweep import header_template, sweep_fast
from ..util import devicewatch as dw
from ..util import telemetry as tm

PROGRAM = "miner_resident"
# launch-shape budget for the resident program: (kernel, tile) pairs — a
# node uses at most the exact + h7 kernels at the production tile plus a
# regtest/bench tile each; a template swap that adds a shape trips the
# sentinel (asserted in the mining tests)
SHAPE_BUDGET = 4

_TILES_C = tm.counter(
    "bcp_mining_tiles_swept_total",
    "Nonce tiles swept by the resident mining loop")
_CANDS_C = tm.counter(
    "bcp_mining_candidates_total",
    "Device candidate hits by outcome (confirmed = host-verified PoW hit, "
    "false_positive = truncated-limb tie resumed past, stale = hit from a "
    "pre-swap template generation, dropped = FIFO overflow)",
    labels=("result",))
_SWAPS_C = tm.counter(
    "bcp_mining_template_swaps_total",
    "Template refreshes applied as device buffer swaps (no new shape)")
_POLLS_C = tm.counter(
    "bcp_mining_polls_total",
    "Host polls of the resident loop (one settled segment each)")
_ROLLOVER_C = tm.counter(
    "bcp_mining_rollovers_total",
    "Nonce-space rollovers (cursor wrapped past 2^32 to 0)")
_POLL_H = tm.histogram(
    "bcp_mining_poll_seconds",
    "Blocking settle wait per resident-loop poll (the oldest in-flight "
    "segment's event)")
_FIFO_G = tm.gauge(
    "bcp_mining_fifo_depth",
    "Confirmed candidate hits parked in the resident loop's FIFO")


def _clamp_segment(cursor: int, want: int, tile: int, cap: int):
    """Boundary-clamped ``(n_tiles, nonces)`` for a segment at ``cursor``:
    the shared ops/miner._boundary_tiles clamp (no wrap past 2^32 inside
    one launch) plus the per-segment tile cap."""
    n_tiles = min(cap, _boundary_tiles(cursor, want, tile))
    return n_tiles, min(n_tiles * tile, (1 << 32) - cursor)


class _Segment:
    __slots__ = ("gen", "start", "n_tiles", "nonces", "out", "event",
                 "bufs")

    def __init__(self, gen, start, n_tiles, nonces, out, event, bufs):
        self.gen = gen              # template generation at enqueue
        self.start = start          # first nonce of the segment
        self.n_tiles = n_tiles
        self.nonces = nonces        # boundary-clamped nonce count
        self.out = out              # (found, nonce, tiles) host tensor
        self.event = event          # settles `out` (None on the CPU)
        self.bufs = bufs            # the template buffers it reads


class ResidentSweep:
    """Long-lived device-resident PoW sweep (see module docstring).

    ``kernel``: "exact" runs the full 8-limb compare (ops/miner.sweep —
    no false positives); "h7" runs the truncated top-limb kernel
    (ops/sha256_sweep.sweep_fast — fewer operations a nonce, candidates
    host-verified). ``tile`` is the launch shape's tile; a template swap
    never changes the (kernel, tile) shape."""

    def __init__(self, tile: int = 1 << 16, seg_tiles: int = 8,
                 inflight: int = 2, fifo_depth: int = 16,
                 kernel: str = "exact"):
        if kernel not in ("exact", "h7"):
            raise ValueError(f"resident kernel {kernel!r}: exact or h7")
        self.tile = int(tile)
        self.seg_tiles = max(1, int(seg_tiles))
        self.inflight = max(1, int(inflight))
        self.kernel = kernel
        self.fifo = deque(maxlen=max(1, int(fifo_depth)))
        self.generation = 0
        self._header76: Optional[bytes] = None
        self._target: Optional[int] = None
        self._tmpl = self._tgt = None   # device buffers (tgt: int t7 for h7)
        self._stream: Optional[torch.cuda.Stream] = None
        self._cursor = 0
        self._segments: deque[_Segment] = deque()
        self._watchdog = False
        # cumulative stats (snapshot() / gettpuinfo.mining)
        self.tiles_swept = 0
        self.nonces_swept = 0
        self.passes = 0
        self.buffer_swaps = 0
        self.polls = 0
        self.hits = 0
        self.false_positives = 0
        self.stale_hits = 0
        self.segments_discarded = 0
        self.fifo_dropped = 0
        self._poll_ema_s = 0.0      # inter-poll cadence (EMA)
        self._last_poll_t = 0.0

    def _on_stream(self):
        return (contextlib.nullcontext() if self._stream is None
                else torch.cuda.stream(self._stream))

    # -- template lifecycle (buffer swap, same launch shape) -------------

    def set_template(self, header80: bytes, target: int) -> int:
        """Install a template. A changed (header bytes 0..75, target)
        makes new same-shape device buffers, bumps the generation, and
        invalidates in-flight segments (their results are counted stale,
        never trusted). Idempotent for an unchanged template."""
        if len(header80) != 80:
            raise ValueError(f"header is {len(header80)} bytes, not 80")
        header76 = header80[:76]
        if header76 == self._header76 and target == self._target:
            return self.generation
        dev = require_device("the resident sweep")
        if dev.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        tmpl = header_template(header80, "cpu")
        tgt = target_tensor(target, "cpu")
        if self._stream is not None:
            tmpl, tgt = tmpl.pin_memory(), tgt.pin_memory()
        with self._on_stream():
            self._tmpl = tmpl.to(dev, non_blocking=True)
            self._tgt = (int(target_to_limbs_np(target)[7])
                         if self.kernel == "h7"
                         else tgt.to(dev, non_blocking=True))
        dw.note_transfer("miner_resident", "h2d", 4 * (
            tmpl.numel() + (tgt.numel() if self.kernel == "exact" else 0)))
        self._header76 = header76
        self._target = target
        self.generation += 1
        self.buffer_swaps += 1
        _SWAPS_C.inc()
        self._cursor = 0
        return self.generation

    # -- segment pipeline -----------------------------------------------

    def _dispatch(self, start: int, n_tiles: int):
        """Launch one segment on the loop's stream under the shape
        sentinel; the signature is (kernel, tile) — template swaps
        re-launch the SAME signature, so the shapes count stays flat.
        Returns (host result tensor, event or None)."""
        with dw.program(PROGRAM, shape_budget=SHAPE_BUDGET).dispatch(
                self.kernel, self.tile):
            with self._on_stream():
                if self.kernel == "h7":
                    res = sweep_fast(self._tmpl, self._tgt, start, n_tiles,
                                     self.tile)
                else:
                    res = sweep(self._tmpl, self._tgt, start, n_tiles,
                                self.tile)
                event = None
                if self._stream is not None:
                    host = torch.empty(3, dtype=torch.int64,
                                       pin_memory=True)
                    host.copy_(res, non_blocking=True)
                    res = host
                    event = torch.cuda.Event()
                    event.record(self._stream)
        dw.note_transfer("miner_resident", "h2d", 8)  # 2 uint32 scalars
        return res, event

    @staticmethod
    def _read(out, event) -> tuple:
        """(found, nonce, tiles) of a launched segment: the poll is
        ``event.query()``; only a segment still running is waited on."""
        if event is not None and not event.query():
            event.synchronize()
        found, nonce, tiles = out.tolist()
        return bool(found), nonce, tiles

    def _pump(self, budget_left: int) -> int:
        """Launch segments (rollover-aware) until the in-flight window
        is full or ``budget_left`` nonces are covered; returns the nonce
        count newly planned."""
        planned = 0
        while (len(self._segments) < self.inflight
               and budget_left - planned > 0):
            n_tiles, nonces = _clamp_segment(
                self._cursor, budget_left - planned, self.tile,
                self.seg_tiles)
            out, event = self._dispatch(self._cursor, n_tiles)
            self._segments.append(_Segment(
                self.generation, self._cursor, n_tiles, nonces, out, event,
                (self._tmpl, self._tgt)))
            planned += nonces
            self._cursor = (self._cursor + nonces) & 0xFFFFFFFF
            if self._cursor == 0:
                self.passes += 1
                _ROLLOVER_C.inc()
        return planned

    def _settle_oldest(self):
        """Settle the oldest in-flight segment; returns (seg, found,
        cand_nonce, tiles_done). Meters the poll, beats the watchdog."""
        seg = self._segments.popleft()
        t0 = time.perf_counter()
        found, nonce, tiles = self._read(seg.out, seg.event)
        dt = time.perf_counter() - t0
        _POLL_H.observe(dt)
        _POLLS_C.inc()
        dw.note_transfer("miner_resident", "d2h", 24, seconds=dt)
        dw.note_phase("miner_resident", "fetch", dt)
        now = time.perf_counter()
        if self._last_poll_t:
            gap = now - self._last_poll_t
            self._poll_ema_s = (gap if self._poll_ema_s == 0.0
                                else 0.8 * self._poll_ema_s + 0.2 * gap)
        self._last_poll_t = now
        self.polls += 1
        self.tiles_swept += tiles
        _TILES_C.inc(tiles)
        dw.WATCHDOG.beat("miner")
        return seg, found, nonce, tiles

    def _confirm(self, nonce: int) -> bool:
        """Host exact-verify of a device candidate (the scalar oracle)."""
        hdr = self._header76 + int(nonce).to_bytes(4, "little")
        return int.from_bytes(sha256d(hdr), "little") <= self._target

    def _resweep_exact(self, start: int, nonces_left: int):
        """Synchronous in-segment resume past an h7 false positive
        (~2^-32 per hash): sweep [start, start+nonces_left) blocking.
        Returns ``(hit, hashed)`` — the first CONFIRMED hit (or None) and
        the number of nonces hashed here, which the caller folds into its
        attempted-hash accounting."""
        hashed = 0
        while nonces_left > 0:
            n_tiles, nonces = _clamp_segment(
                start, nonces_left, self.tile, self.seg_tiles)
            found, cand, tiles = self._read(*self._dispatch(start, n_tiles))
            done = min(tiles * self.tile, nonces)
            self.tiles_swept += tiles
            self.nonces_swept += done
            hashed += done
            _TILES_C.inc(tiles)
            if not found:
                return None, hashed
            if self._confirm(cand):
                return cand, hashed
            self.false_positives += 1
            _CANDS_C.labels(result="false_positive").inc()
            consumed = ((cand - start) & 0xFFFFFFFF) + 1
            nonces_left -= consumed
            start = (cand + 1) & 0xFFFFFFFF
        return None, hashed

    # -- the sweep_header-contract driver -------------------------------

    def sweep(self, header80: bytes, target: int, start_nonce: int = 0,
              max_nonces: int = 1 << 32, tile: Optional[int] = None):
        """Search [start_nonce, start_nonce+max_nonces) (rollover past
        2^32, one full pass max) for the first nonce in sweep order with
        sha256d(header) <= target. Same contract as
        ops/miner.sweep_header; ``tile`` is accepted for signature
        compatibility and ignored — the resident loop owns its tile. A
        changed header/target is a buffer swap; in-flight segments of the
        old generation are discarded unsettled."""
        gen = self.set_template(header80, target)
        # stale in-flight segments (previous template or previous call's
        # cursor) never contribute: drop them — the device work completes
        # harmlessly on the loop's stream
        self.segments_discarded += len(self._segments)
        self._segments.clear()
        self._cursor = start_nonce & 0xFFFFFFFF
        budget = min(max_nonces, 1 << 32)
        swept = 0
        planned = self._pump(budget)
        while self._segments:
            seg, found, cand, tiles = self._settle_oldest()
            done = min(tiles * self.tile, seg.nonces)
            swept += done
            self.nonces_swept += done
            if found and seg.gen != gen:  # defensive: direct-pump users
                self.stale_hits += 1
                _CANDS_C.labels(result="stale").inc()
            elif found:
                if self._confirm(cand):
                    self._record_hit()
                    self.segments_discarded += len(self._segments)
                    self._segments.clear()
                    return cand, swept
                # h7 limb tie: resume synchronously inside the segment
                self.false_positives += 1
                _CANDS_C.labels(result="false_positive").inc()
                after = ((cand - seg.start) & 0xFFFFFFFF) + 1
                hit, hashed = self._resweep_exact(
                    (cand + 1) & 0xFFFFFFFF, seg.nonces - after)
                swept += hashed
                if hit is not None:
                    self._record_hit()
                    self.segments_discarded += len(self._segments)
                    self._segments.clear()
                    return hit, swept
            planned += self._pump(budget - planned)
        return None, swept

    def advance(self, nonce_budget: int) -> int:
        """Continuous-mining poll surface: sweep up to ``nonce_budget``
        nonces forward from the loop's cursor (rollover-aware, template
        already installed via set_template), parking confirmed hits in
        the FIFO for ``take_hits()`` instead of returning the first one.
        A hit does not stop the sweep. Returns the number of new
        confirmed hits parked."""
        if self._header76 is None:
            raise RuntimeError("set_template first")
        gen = self.generation
        new_hits = 0
        planned = self._pump(nonce_budget)
        while self._segments:
            seg, found, cand, tiles = self._settle_oldest()
            self.nonces_swept += min(tiles * self.tile, seg.nonces)
            if found and seg.gen == gen and self._confirm(cand):
                self._push_hit(cand)
                new_hits += 1
            elif found and seg.gen == gen:
                # h7 limb tie: the kernel stopped the segment at the false
                # positive, but the cursor already moved past the whole
                # segment — resume the remainder synchronously, or a REAL
                # hit in (cand, seg end) would be lost until a rollover
                self.false_positives += 1
                _CANDS_C.labels(result="false_positive").inc()
                after = ((cand - seg.start) & 0xFFFFFFFF) + 1
                hit, _ = self._resweep_exact(
                    (cand + 1) & 0xFFFFFFFF, seg.nonces - after)
                if hit is not None:
                    self._push_hit(hit)
                    new_hits += 1
            elif found:
                self.stale_hits += 1
                _CANDS_C.labels(result="stale").inc()
            planned += self._pump(nonce_budget - planned)
        return new_hits

    def _record_hit(self) -> None:
        self.hits += 1
        _CANDS_C.labels(result="confirmed").inc()

    def _push_hit(self, nonce: int) -> None:
        """Park a confirmed hit in the bounded FIFO (oldest dropped on
        overflow, metered)."""
        if len(self.fifo) == self.fifo.maxlen:
            self.fifo_dropped += 1
            _CANDS_C.labels(result="dropped").inc()
        self.fifo.append({"nonce": int(nonce),
                          "generation": self.generation})
        self._record_hit()
        _FIFO_G.set(len(self.fifo))

    def take_hits(self) -> list:
        """Drain the confirmed-candidate FIFO (host poll surface)."""
        out = list(self.fifo)
        self.fifo.clear()
        _FIFO_G.set(0)
        return out

    # -- lifecycle / observability --------------------------------------

    def register_watchdog(self, quiet_s: Optional[float] = None) -> None:
        """Register the ``miner`` stall-watchdog subsystem: pending work
        is the in-flight segment count; every settled poll beats."""
        dw.WATCHDOG.register("miner",
                             pending_fn=lambda: len(self._segments),
                             quiet_s=quiet_s)
        self._watchdog = True

    def close(self) -> None:
        self._segments.clear()
        self._tmpl = self._tgt = None
        if self._watchdog:
            dw.WATCHDOG.unregister("miner")
            self._watchdog = False

    def snapshot(self) -> dict:
        """gettpuinfo's ``mining`` section (resident-loop state)."""
        return {
            "resident": True,
            "kernel": self.kernel,
            "tile": self.tile,
            "seg_tiles": self.seg_tiles,
            "inflight_limit": self.inflight,
            "inflight": len(self._segments),
            "template_generation": self.generation,
            "buffer_swaps": self.buffer_swaps,
            "tiles_swept": self.tiles_swept,
            "nonces_swept": self.nonces_swept,
            "rollover_passes": self.passes,
            "polls": self.polls,
            "poll_cadence_s": round(self._poll_ema_s, 6),
            "fifo_depth": len(self.fifo),
            "fifo_capacity": self.fifo.maxlen,
            "fifo_dropped": self.fifo_dropped,
            "hits": self.hits,
            "false_positives": self.false_positives,
            "stale_hits": self.stale_hits,
            "segments_discarded": self.segments_discarded,
        }
