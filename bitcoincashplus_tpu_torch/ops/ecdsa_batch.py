"""ECDSA batch dispatch — the host side of the signature kernels.

Port of the reference's ops/ecdsa_batch.py for the ``-ecdsakernel=glv``
(the default), ``-ecdsakernel=w4`` and ``-ecdsakernel=msm`` rungs. The
block's deferred
sigcheck records are packed on the host (w = s^-1, u1 = e w, u2 = r w;
byte matrices or 13-bit limb planes) and verified in one launch of a
hand-written CUDA kernel (ops/secp256k1.py, csrc/*.cu). The ladder, as the
reference's:

  - GLV with the split on the device (``ecdsa_verify_batch_glv_dev``,
    entry glv_dev_verify): the w4 byte matrices, buckets of 1024 lanes
    and more;
  - GLV from the host split (``pack_records_glv``,
    ``ecdsa_verify_batch_glv``, entry glv_verify);
  - w4: buckets of 1024 lanes and more as byte matrices, expanded in the
    kernel (``ecdsa_verify_batch_pallas_w4_bytes``, entry
    w4_verify_bytes); the small buckets 32 and 128 as host-expanded
    window and limb planes (``ecdsa_verify_batch_pallas_w4``, entry
    w4_verify_planes);
  - the bit ladder, when ``BCP_SECP_PALLAS=0`` turns the w4 rung off
    (``pallas_enabled``): ``pack_records``' (256, B) bit planes at the
    plane buckets (``ecdsa_verify_batch_jit``, entry ladder_verify); the
    packed entry then sends its blobs down the record route unless GLV
    is the kernel;
  - the packed blobs of the native connect engine (``dispatch_packed``),
    in 8190-lane slices (bucket 8192), down the same ladder from the
    GLV device split;
  - under ``msm``, the Schnorr lanes of a batch (65-byte signatures) go
    to the Pippenger batch check (``_dispatch_msm``: one MSM over the
    batch equation on the card, ops/secp256k1.schnorr_msm_is_infinity,
    csrc/msm.cu), behind the reference's canary batches, bisection and
    host prechecks; the ECDSA lanes take the GLV ladder.

Kept from the reference: the bucket sets, the two known-answer lanes on
every device batch, the host re-verify of degenerate lanes, the host
confirmation of every device False, the MSM rung's canary batches,
bisection and counters, the ecdsa circuit breaker with its retries and
fault sites (``ecdsa``, ``ecdsa_glv``, ``ecdsa_glv_dev``, ``ecdsa_msm``),
BatchHandle, SigBatchFuture and LanePacker.

Differences, all deliberate: the ladder steps down a rung (GLV device
split -> GLV host split -> w4) only for a fault the harness injected
(``BCP_FAULT_*`` on ``ecdsa_glv_dev`` or ``ecdsa_glv``); every other
failure of a GLV leg raises ``KernelUnavailable``, and so do
known-answer lanes that come back wrong when no fault poisoned them. In
the same way the per-lane Schnorr oracle serves an MSM batch only after
a fault injected at ``ecdsa_msm`` or ``ecdsa`` (a fail-* mode, or a
canary trip from poison-output); any other failure of the MSM rung
raises. The oracle's other routes are the reference's own: lanes the
host prechecks reject, sub-batches of ``MSM_MIN_BATCH`` or fewer, and
``auto`` batches below ``CPU_FLOOR``. Under ``msm`` the packed entry's
ECDSA lanes take the GLV ladder, as the record entry's do. The device is ``cuda`` unless
``set_device("cpu")`` (ops/cuda_build.py, re-exported here) selects the
plain PyTorch versions (the tests). A kernel that cannot be built or
launched raises ``KernelUnavailable`` through the supervision, and so
does a CUDA runtime error that torch reports from the kernel's launch or
its verdict read (an illegal address); neither is degraded to the CPU,
and with no card and no CPU device selected the device leg raises too.

CPU fallback (``backend="cpu"``, batches below the dispatch floor, or a
breaker-supervised device failure) runs the native C++ verify or the
Python-int oracle.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..crypto import secp256k1 as oracle
from ..util import devicewatch as dw
from ..util import telemetry as tm
from ..util.faults import INJECTOR, Backoff, InjectedFault, PoisonedOutput
from ..util.log import log_printf
from . import dispatch
# set_device and device_names (gettpuinfo's device list) are re-exported:
# the device switch is shared by every kernel module of the port
# (ops/cuda_build.py)
from .cuda_build import (KernelUnavailable, device, device_names,
                         raise_kernel_fault, require_device, set_device)

# -- telemetry families (util/telemetry): per-stage host-pack latency,
# device settle-wait distribution, dispatch/flush lane-size histograms,
# and the lane-fill / in-flight gauges. STATS itself is projected onto
# the registry by the collector below, so getmetrics' /metrics namespace
# and the info RPC's `batch` section read the same counters.
_STAGE_H = tm.histogram(
    "bcp_ecdsa_stage_seconds",
    "Host pack-stage latency per dispatch (decompose = GLV lattice split, "
    "pack = byte-matrix emit)", labels=("stage",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0))
_SETTLE_H = tm.histogram(
    "bcp_ecdsa_settle_wait_seconds",
    "Blocking wait at BatchHandle.result() — near zero when the pipeline "
    "hid the device latency")
_LANES_H = tm.histogram(
    "bcp_ecdsa_dispatch_lanes",
    "Real (unpadded) lanes per device dispatch",
    buckets=(32, 128, 512, 1024, 2048, 4096, 8192, 16384, 32768))
_PACKER_FLUSH_H = tm.histogram(
    "bcp_packer_flush_lanes",
    "Lanes per cross-block LanePacker bucket flush",
    buckets=(32, 128, 512, 1024, 2046, 4096, 8190, 16384))
_LANE_FILL_G = tm.gauge(
    "bcp_packer_lane_fill_pct",
    "Cumulative real-lane fill of padded device buckets (percent)")
_IN_FLIGHT_G = tm.gauge(
    "bcp_ecdsa_in_flight",
    "Device verify dispatches currently in flight")


def _collect_ecdsa_stats():
    """Registry collector: every numeric BatchStats field as
    bcp_ecdsa_<field>, plus per-bucket dispatch counts. in_flight is
    excluded — the native _IN_FLIGHT_G gauge already owns that name, and
    a collector re-emitting it would duplicate the family with a
    conflicting TYPE in the Prometheus exposition."""
    snap = STATS.snapshot()
    snap.pop("in_flight", None)
    buckets = snap.pop("buckets_used", {})
    out = tm.flat_families("bcp_ecdsa", snap, typ="counter",
                           help="ops/ecdsa_batch.STATS")
    if buckets:
        out.append({
            "name": "bcp_ecdsa_bucket_dispatches_total", "type": "counter",
            "help": "Device dispatches per padded bucket size",
            "samples": [({"bucket": str(b)}, n)
                        for b, n in sorted(buckets.items())],
        })
    return out


tm.register_collector("ecdsa_stats", _collect_ecdsa_stats)

# Pad-to-bucket sizes; the record path's small buckets (<= 128 lanes) run
# the plane entry, everything above the byte entry in multiples of 1024.
BUCKETS = (32, 128, 512, 2048, 8192, 16384, 32768)
# Below this lane count a device round-trip costs more than host verify.
CPU_FLOOR = 8

# ---- device-lane watches (util/devicewatch) --------------------------------
# The byte-pipeline ladder is {1024, 2048, 4096} then 2048-granular to
# 16384 = 9 shapes (_bucket_for pallas=True; the reference's program split
# at 16384 keeps larger batches on those shapes); the plane entry pads to
# BUCKETS. Both GLV legs take the byte ladder.
PALLAS_SHAPE_BUDGET = 9
_PW_GLV = dw.program("ecdsa_glv", shape_budget=PALLAS_SHAPE_BUDGET)
_PW_GLV_DEV = dw.program("ecdsa_glv_decompose",
                         shape_budget=PALLAS_SHAPE_BUDGET)
_PW_W4_BYTES = dw.program("ecdsa_w4_bytes", shape_budget=PALLAS_SHAPE_BUDGET)
_PW_W4 = dw.program("ecdsa_w4", shape_budget=len(BUCKETS))
# the bit ladder (BCP_SECP_PALLAS=0) pads to BUCKETS
_PW_XLA = dw.program("ecdsa_xla", shape_budget=len(BUCKETS))
# The Pippenger MSM batch check: term counts pad to the _MSM_BUCKETS
# ladder, and the canary batches reuse the smallest bucket, so the shape
# set is exactly that ladder.
_MSM_BUCKETS = (64, 256, 1024, 4096, 8192, 16384)
MSM_SHAPE_BUDGET = len(_MSM_BUCKETS)
_PW_MSM = dw.program("ecdsa_msm", shape_budget=MSM_SHAPE_BUDGET)
# A batch of n Schnorr sigs costs M = 2n + 1 MSM terms (R_i, P_i and the
# shared G term); the cap keeps M inside the largest bucket (bigger
# submissions chunk, each chunk an independent batch equation).
MSM_MAX_RECORDS = 8190
# Below this the bisection hands lanes straight to the per-lane oracle.
MSM_MIN_BATCH = 8


def _to_device(arrays) -> list:
    """Host numpy arrays -> tensors on the port's device (uint32 planes
    travel as int32 bit patterns: the kernel reads 32-bit words)."""
    dev = device()
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(dev, non_blocking=True))
    return out


def _watched_kernel(pw, bucket: int, arrays, fn, split: int | None = 16384):
    """One watched kernel call: the program watch sees the shape
    signature, h2d staging bytes and the execute phase land in the
    transfer/phase accounting. ``arrays`` are the packed host-side numpy
    inputs (their nbytes IS the staging payload). ``split`` caps the
    signature as the reference's 16384-lane program split did, so the
    shape budget means the same thing in both packages."""
    dw.note_transfer("ecdsa", "h2d",
                     sum(int(a.nbytes) for a in arrays))
    sig = bucket if split is None else min(bucket, split)
    t0 = time.monotonic()
    with pw.dispatch(sig):
        out = fn(*_to_device(arrays))
    dw.note_phase("ecdsa", "execute", time.monotonic() - t0)
    return out


# ---- device and kernel selection --------------------------------------------

# "glv": the endomorphism split verifier (32 windows over the Q and
# lambda Q streams and the fixed-base G comb; the default, as in the
# reference); "w4": the 64-window kernel, the rung below it; "msm": the
# Pippenger batch check for the Schnorr lanes (ECDSA lanes under it take
# the GLV ladder).
ECDSA_KERNELS = ("glv", "w4", "msm")
# Fault-injection sites of the GLV legs, explicit opt-in only (util/faults):
# fail-* on GLV_DEV_SITE steps the device-split leg down to the host split,
# on GLV_SITE (which both GLV legs consult) down to w4; poison-output on
# either proves the known-answer gate.
GLV_SITE = "ecdsa_glv"
GLV_DEV_SITE = "ecdsa_glv_dev"
# The MSM batch check's site, explicit-only like the GLV legs: fail-*
# sends the batch to the per-lane oracle, poison-output flips every batch
# verdict (canaries included) and so trips the canary gate.
MSM_SITE = "ecdsa_msm"
_KERNEL = None  # set_kernel() override; None = BCP_ECDSA_KERNEL or "glv"
_BAD_ENV_WARNED = False


def active_kernel() -> str:
    """The kernel the next device dispatch will try first. An invalid
    BCP_ECDSA_KERNEL value falls back to the default with a one-time
    warning (this runs on the dispatch hot path, so it must not raise)."""
    global _BAD_ENV_WARNED
    if _KERNEL is not None:
        return _KERNEL
    env = os.environ.get("BCP_ECDSA_KERNEL", "glv")
    if env in ECDSA_KERNELS:
        return env
    if not _BAD_ENV_WARNED:
        _BAD_ENV_WARNED = True
        log_printf("BCP_ECDSA_KERNEL=%r is not one of %s — using 'glv'",
                   env, "/".join(ECDSA_KERNELS))
    return "glv"


def set_kernel(name: str) -> str:
    """Select the device verify kernel ("glv", "w4" or "msm"); raises
    ValueError for any other name."""
    global _KERNEL
    if name not in ECDSA_KERNELS:
        raise ValueError(
            f"-ecdsakernel={name!r}: unknown kernel "
            f"(valid: {', '.join(ECDSA_KERNELS)})"
        )
    _KERNEL = name
    return name


def glv_enabled() -> bool:
    """Gate of the GLV legs, as the reference's host modules read it. The
    port never latches a rung off (an injected fault steps down one
    dispatch; any other failure raises), so it is always True."""
    return True


def glv_dev_enabled() -> bool:
    """Gate of the device-split GLV leg (the first rung); always True, as
    glv_enabled."""
    return True


def pallas_enabled() -> bool:
    """The reference's switch between the w4 kernels and the bit ladder:
    ``BCP_SECP_PALLAS=0`` (or ``false``) turns the w4 rung off, so the
    record dispatch runs the bit ladder (ecdsa_verify_batch_jit) at the
    plane buckets, and the packed entry sends its blobs down the record
    route unless GLV is the kernel. Read at every call. The reference also
    latched it off after a Mosaic failure; the port has no such latch (a
    w4 failure raises KernelUnavailable)."""
    return os.environ.get("BCP_SECP_PALLAS", "1") not in ("0", "false")


def kernel_info() -> dict:
    """The info RPC's ``ecdsa`` section, with the reference's keys: the
    active kernel, GLV health (never latched here), the comb's one-time
    build cost, the pack-stage split and the MSM counters."""
    from . import secp256k1 as dev_mod

    return {
        "kernel": active_kernel(),
        "kernels": list(ECDSA_KERNELS),
        "glv_broken": False,
        "glv_dispatches": STATS.glv_dispatches,
        "glv_fallbacks": STATS.glv_fallbacks,
        "table_build_s": round(dev_mod.GLV_TABLE_BUILD_S, 4),
        "decompose_s": round(STATS.glv_decompose_s, 4),
        "pack_s": round(STATS.glv_pack_s, 4),
        "emit_s": round(STATS.glv_emit_s, 4),
        "dispatch_s": round(STATS.glv_dispatch_s, 4),
        "dev_decompose": {
            "enabled": glv_dev_enabled(),
            "broken": False,
            "dispatches": STATS.glv_dev_dispatches,
            "fallbacks": STATS.glv_dev_fallbacks,
        },
        "msm": {
            "schnorr_sigs": STATS.schnorr_sigs,
            "schnorr_cpu_sigs": STATS.schnorr_cpu_sigs,
            "dispatches": STATS.msm_dispatches,
            "batches_accepted": STATS.msm_batches_accepted,
            "batches_rejected": STATS.msm_batches_rejected,
            "bisects": STATS.msm_bisects,
            "bisect_depth_max": STATS.msm_bisect_depth_max,
            "fallback_sigs": STATS.msm_fallback_sigs,
            "canary_failures": STATS.msm_canary_failures,
        },
    }


@dataclass
class BatchStats:
    """Per-dispatch metrics surfaced via the info RPC."""

    dispatches: int = 0
    sigs_verified: int = 0
    sigs_padded: int = 0
    cpu_fallback_sigs: int = 0
    # sigchecks that never reach the batch at all:
    eager_multisig_sigs: int = 0   # CHECKMULTISIG trials, verified inline
    inline_legacy_sigs: int = 0    # pre-NULLFAIL blocks, deferral unsound
    sigcache_hits: int = 0         # records dropped by the sigcache probe
    p2pkh_fast_path: int = 0       # inputs that skipped the generic EvalScript
    device_seconds: float = 0.0
    last_batch: int = 0
    # pipeline overlap: dispatches currently in flight / high-water mark
    in_flight: int = 0
    max_in_flight: int = 0
    # w4/glv kernel lanes flagged degenerate (adversarially-crafted H == 0
    # collisions) and re-verified on the CPU path — see ops/secp256k1.py
    degenerate_rechecks: int = 0
    # GLV kernel accounting: dispatches that ran a GLV kernel, injected
    # GLV-leg faults that stepped down to the w4 kernel, and the host-side
    # pack stage split (lattice decomposition vs byte packing)
    glv_dispatches: int = 0
    glv_fallbacks: int = 0
    glv_decompose_s: float = 0.0
    glv_pack_s: float = 0.0
    # device-split leg: dispatches of glv_dev_verify, injected faults that
    # stepped down to the host split, and the emit/dispatch stages
    # (decompose_s above stays HOST decompose only — ~0 while the device
    # leg runs; emit_s is the numpy byte emission across BOTH GLV legs;
    # dispatch_s is the host-side enqueue of the GLV kernels)
    glv_dev_dispatches: int = 0
    glv_dev_fallbacks: int = 0
    glv_emit_s: float = 0.0
    glv_dispatch_s: float = 0.0
    # supervised-dispatch accounting (ops/dispatch breaker layer): sigs
    # re-verified on the CPU engine because the device path failed or its
    # known-answer lanes came back wrong. NOTE sigs_padded includes the 2
    # KAT lanes riding every device batch.
    fault_fallback_sigs: int = 0
    kat_failures: int = 0
    # device-False lanes host-confirmed before they could reject a block
    reject_confirm_sigs: int = 0
    # Schnorr + MSM batch verification: schnorr_sigs counts every Schnorr
    # record entering dispatch; schnorr_cpu_sigs the ones settled by the
    # per-lane oracle (no MSM, bisect base cases, and injected-fault
    # re-verifies). msm_dispatches counts MSM kernel calls (canary batches
    # included); a rejected batch bisects (msm_bisects, with the deepest
    # split level in msm_bisect_depth_max). msm_fallback_sigs are lanes
    # that left the MSM rung after injected faults; msm_canary_failures
    # are canary-gate trips (also kat_failures). The port's own split of
    # the MSM time: msm_host_s the host work of each check (challenges,
    # coefficients, the byte pack), msm_device_s its kernel call with the
    # wait for the verdict, msm_canary_s the whole canary checks.
    schnorr_sigs: int = 0
    schnorr_cpu_sigs: int = 0
    msm_dispatches: int = 0
    msm_batches_accepted: int = 0
    msm_batches_rejected: int = 0
    msm_bisects: int = 0
    msm_bisect_depth_max: int = 0
    msm_fallback_sigs: int = 0
    msm_canary_failures: int = 0
    msm_host_s: float = 0.0
    msm_device_s: float = 0.0
    msm_canary_s: float = 0.0
    buckets_used: dict = field(default_factory=dict)

    def snapshot(self) -> dict:
        d = self.__dict__.copy()
        d["buckets_used"] = dict(self.buckets_used)
        return d


STATS = BatchStats()


def _note_device_dispatch(n: int, bucket: int) -> None:
    """Shared per-dispatch STATS bookkeeping (record-level and packed
    entry points must never diverge on the counters)."""
    STATS.dispatches += 1
    STATS.sigs_verified += n
    STATS.sigs_padded += bucket - n
    STATS.last_batch = n
    STATS.buckets_used[bucket] = STATS.buckets_used.get(bucket, 0) + 1
    STATS.in_flight += 1
    STATS.max_in_flight = max(STATS.max_in_flight, STATS.in_flight)
    _LANES_H.observe(n)
    _IN_FLIGHT_G.set(STATS.in_flight)


def _bucket_for(n: int, pallas: bool = False) -> int:
    if pallas and n > 128:
        # byte-entry buckets, the reference's ladder: {1024, 2048, 4096},
        # then 2048-granular up to 16384, then 16384-granular. A CUDA
        # launch has no compiled shape to bound, but the ladder keeps the
        # shape set (and the devicewatch budget) the reference's, and
        # 2048-granularity bounds the padding waste at ~33% (n=4097 ->
        # 6144). Batches <= 128 lanes use the plane entry's small buckets.
        if n <= 1024:
            return 1024
        if n <= 4096:
            return 2048 if n <= 2048 else 4096
        if n <= 16384:
            return ((n + 2047) // 2048) * 2048
        return ((n + 16383) // 16384) * 16384
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + BUCKETS[-1] - 1) // BUCKETS[-1]) * BUCKETS[-1]


def decompose_scalars(records: Sequence) -> list[tuple[int, int]]:
    """Step 1: (u1, u2) per record. Records carry (r, s, msg_hash)."""
    out = []
    for rec in records:
        w = pow(rec.s, oracle.N - 2, oracle.N)
        out.append((rec.msg_hash * w % oracle.N, rec.r * w % oracle.N))
    return out


def _scalar_bitplanes(records: Sequence, n: int) -> tuple:
    """(u1, u2) for all records as (n, 32) big-endian byte matrices, ready
    for unpackbits. Native C++ when available (bcp_ecdsa_precompute — the
    Python pow() loop was ~40% of host pack time at 10k sigs), else the
    Python-int path. Range-invalid records (never produced by the deferral
    layer, which pre-checks) come back flagged; callers poison those lanes."""
    from .. import native

    if native.available():
        u1_blob, u2_blob, ok = native.ecdsa_precompute(records)
        u1 = np.frombuffer(u1_blob, np.uint8).reshape(n, 32)
        u2 = np.frombuffer(u2_blob, np.uint8).reshape(n, 32)
        return u1, u2, ok
    scalars = decompose_scalars(records)
    u1 = np.frombuffer(
        b"".join(u1.to_bytes(32, "big") for u1, _ in scalars), np.uint8
    ).reshape(n, 32)
    u2 = np.frombuffer(
        b"".join(u2.to_bytes(32, "big") for _, u2 in scalars), np.uint8
    ).reshape(n, 32)
    return u1, u2, None


_LIMB_WEIGHTS = (1 << np.arange(13)).astype(np.uint32)


def _limb_cols(blob: bytes, n: int, bucket: int) -> np.ndarray:
    """n concatenated 32-byte big-endian values -> (20, bucket) 13-bit limb
    columns (padding lanes zero). Fully vectorized — the per-record
    to_limbs_np loop was ~60% of host pack time at 10k sigs."""
    from . import secp256k1 as dev

    mat = np.frombuffer(blob, np.uint8).reshape(n, 32)
    bits = np.unpackbits(mat, axis=1)[:, ::-1]  # LSB-first bit order
    bits = np.concatenate(
        [bits, np.zeros((n, 13 * dev.JAX_N_LIMBS - 256), np.uint8)], axis=1
    )
    limbs = (
        bits.reshape(n, dev.JAX_N_LIMBS, 13).astype(np.uint32) * _LIMB_WEIGHTS
    ).sum(axis=2)
    out = np.zeros((dev.JAX_N_LIMBS, bucket), np.uint32)
    out[:, :n] = limbs.T
    return out


def _pack_limbs(records: Sequence, bucket: int):
    """Shared SoA limb packing: pubkey/r limbs + poison masks, padded to
    ``bucket`` lanes. Padded lanes get q_inf=True (poisoned: kernel reports
    False) and are masked out by the caller — they can never turn a bad
    batch good or a good batch bad. Returns the (n, 32) u1/u2 scalar byte
    matrices alongside (the caller picks bit planes or window planes)."""
    n = len(records)
    u1_bytes, u2_bytes, range_ok = _scalar_bitplanes(records, n)
    wraps = [rec.r + oracle.N < oracle.P for rec in records]
    qx = _limb_cols(
        b"".join(rec.pubkey[0].to_bytes(32, "big") for rec in records),
        n, bucket)
    qy = _limb_cols(
        b"".join(rec.pubkey[1].to_bytes(32, "big") for rec in records),
        n, bucket)
    r0 = _limb_cols(
        b"".join(rec.r.to_bytes(32, "big") for rec in records), n, bucket)
    rn = _limb_cols(
        b"".join(
            (rec.r + oracle.N if w else rec.r).to_bytes(32, "big")
            for rec, w in zip(records, wraps)
        ), n, bucket)
    q_inf = np.ones(bucket, bool)  # default poisoned (padding)
    wrap_ok = np.zeros(bucket, bool)
    wrap_ok[:n] = wraps
    # real lanes un-poisoned, except any the precompute range-flagged
    q_inf[:n] = False if range_ok is None else ~np.asarray(range_ok, bool)
    return u1_bytes, u2_bytes, qx, qy, q_inf, r0, rn, wrap_ok


def pack_records(records: Sequence, bucket: int):
    """Step 2+3 for the bit-ladder kernel: SoA arrays padded to ``bucket``
    lanes with (256, B) MSB-first bit planes. unpackbits on the 32-byte
    big-endian scalars — vectorized, not a 256·B Python loop (host packing
    must stay negligible next to the device dispatch)."""
    n = len(records)
    u1_bytes, u2_bytes, qx, qy, q_inf, r0, rn, wrap_ok = _pack_limbs(
        records, bucket
    )
    u1b = np.zeros((256, bucket), np.uint32)
    u2b = np.zeros((256, bucket), np.uint32)
    u1b[:, :n] = np.unpackbits(u1_bytes, axis=1).T
    u2b[:, :n] = np.unpackbits(u2_bytes, axis=1).T
    return u1b, u2b, qx, qy, q_inf, r0, rn, wrap_ok


def pack_records_w4(records: Sequence, bucket: int):
    """Record pack for the w4 plane entry (buckets 32 and 128): (64, B)
    4-bit window planes and (20, B) 13-bit limb planes."""
    from . import secp256k1 as dev

    u1_bytes, u2_bytes, qx, qy, q_inf, r0, rn, wrap_ok = _pack_limbs(
        records, bucket
    )
    u1w = dev.bits_to_windows_np(u1_bytes, bucket)
    u2w = dev.bits_to_windows_np(u2_bytes, bucket)
    return u1w, u2w, qx, qy, q_inf, r0, rn, wrap_ok


def _zeros(into, i: int, shape) -> np.ndarray:
    """A pack's i-th output: a new zeroed uint8 array of ``shape``, or
    ``into[i]`` (a kept buffer of that shape: the sharded path's staging)
    zeroed in place."""
    if into is None:
        return np.zeros(shape, np.uint8)
    into[i][...] = 0
    return into[i]


def _ones(into, i: int, shape) -> np.ndarray:
    """As _zeros, filled with ones (the q_inf plane: padding is
    poisoned)."""
    if into is None:
        return np.ones(shape, np.uint8)
    into[i][...] = 1
    return into[i]


# the bytes of a lane of each output of the packs, in order (32 or 16: a
# (bucket, w) matrix; 1: a (bucket,) plane)
W4_BYTES_ROW = (32, 32, 32, 32, 1, 32, 32, 1)
GLV_ROW = (16, 16, 1, 1, 16, 16, 1, 32, 32, 1, 32, 32, 1)
MSM_ROW = (32, 32, 1, 32)


def pack_records_w4_bytes(records: Sequence, bucket: int, into=None):
    """Byte-matrix pack for the single-dispatch w4 pipeline: every 256-bit
    field as a (bucket, 32) big-endian uint8 matrix (window/limb expansion
    happens in the kernel — ops/secp256k1 entry w4_verify_bytes), masks as uint8
    vectors. ~5x less host->device traffic than the expanded planes.
    ``into``: the eight arrays to fill in place (kept buffers; every lane
    is written), else new ones."""
    n = len(records)
    u1_bytes, u2_bytes, range_ok = _scalar_bitplanes(records, n)
    wraps = [rec.r + oracle.N < oracle.P for rec in records]

    def mat(blob: bytes, i: int) -> np.ndarray:
        out = _zeros(into, i, (bucket, 32))
        out[:n] = np.frombuffer(blob, np.uint8).reshape(n, 32)
        return out

    u1m = _zeros(into, 0, (bucket, 32))
    u1m[:n] = u1_bytes
    u2m = _zeros(into, 1, (bucket, 32))
    u2m[:n] = u2_bytes
    qxb = mat(b"".join(rec.pubkey[0].to_bytes(32, "big") for rec in records),
              2)
    qyb = mat(b"".join(rec.pubkey[1].to_bytes(32, "big") for rec in records),
              3)
    r0b = mat(b"".join(rec.r.to_bytes(32, "big") for rec in records), 5)
    rnb = mat(b"".join(
        (rec.r + oracle.N if w else rec.r).to_bytes(32, "big")
        for rec, w in zip(records, wraps)
    ), 6)
    q_inf = _ones(into, 4, bucket)
    q_inf[:n] = 0 if range_ok is None else \
        (~np.asarray(range_ok, bool)).astype(np.uint8)
    wrap8 = _zeros(into, 7, bucket)
    wrap8[:n] = np.asarray(wraps, np.uint8)
    return u1m, u2m, qxb, qyb, q_inf, r0b, rnb, wrap8


def _glv_pack_parts(u1_bytes, u2_bytes, qx_bytes, qy_bytes, r_bytes,
                    rn_bytes, wraps, range_bad, bucket: int, into=None):
    """Shared host-split GLV pack (the rung below the device split):
    lattice-decompose the (u1, u2) scalars with the numpy limb-batch
    split (ops/secp256k1.glv_split_batch_np) and emit the glv_verify
    kernel's byte matrices. u1/u2/qx/qy/r/rn: (n, 32) uint8 big-endian.
    range_bad: (n,) bool poison mask or None. ``into``: the thirteen
    arrays to fill in place (kept buffers; every lane is written), else
    new ones. Decompose and emit stages are timed into STATS."""
    from . import secp256k1 as dev

    n = len(qy_bytes)
    t0 = time.monotonic()
    if n:
        a1m, na1, a2m, na2 = dev.glv_decompose_batch_np(u1_bytes)
        b1m, nb1, b2m, nb2 = dev.glv_decompose_batch_np(u2_bytes)
    dt = time.monotonic() - t0
    STATS.glv_decompose_s += dt
    _STAGE_H.labels(stage="decompose").observe(dt)
    dw.note_phase("ecdsa", "decompose", dt)

    t0 = time.monotonic()
    d1m = _zeros(into, 0, (bucket, 16))
    d2m = _zeros(into, 1, (bucket, 16))
    s1m = _zeros(into, 4, (bucket, 16))
    s2m = _zeros(into, 5, (bucket, 16))
    sg1 = _zeros(into, 2, bucket)
    sg2 = _zeros(into, 3, bucket)
    ydiff = _zeros(into, 6, bucket)
    qyb = _zeros(into, 8, (bucket, 32))
    if n:
        # comb digits little-endian (position i = weight 256^i); ladder
        # scalars big-endian (MSB-first nibble windows on device)
        d1m[:n] = a1m
        d2m[:n] = a2m
        s1m[:n] = b1m[:, ::-1]
        s2m[:n] = b2m[:, ::-1]
        sg1[:n] = na1
        sg2[:n] = na2
        ydiff[:n] = nb1 ^ nb2
        # first Q-stream sign folds into qy (device never negates Q)
        fold = nb1.astype(bool)
        qyb[:n] = qy_bytes
        if fold.any():
            qyb[:n][fold] = dev.field_neg_bytes_np(qy_bytes[fold])

    def pad(mat: np.ndarray, i: int) -> np.ndarray:
        out = _zeros(into, i, (bucket, 32))
        out[:n] = mat
        return out

    q_inf = _ones(into, 9, bucket)
    q_inf[:n] = (np.asarray(range_bad, bool).astype(np.uint8)
                 if range_bad is not None else 0)
    wrap8 = _zeros(into, 12, bucket)
    wrap8[:n] = np.asarray(wraps, np.uint8)
    out = (d1m, d2m, sg1, sg2, s1m, s2m, ydiff, pad(qx_bytes, 7), qyb,
           q_inf, pad(r_bytes, 10), pad(rn_bytes, 11), wrap8)
    dt = time.monotonic() - t0
    STATS.glv_pack_s += dt
    STATS.glv_emit_s += dt
    _STAGE_H.labels(stage="pack").observe(dt)
    dw.note_phase("ecdsa", "pack", dt)
    return out




def pack_records_glv(records: Sequence, bucket: int, into=None):
    """pack_records for the GLV kernel: split scalars + signs (the packer
    emits the λ-decomposition; LanePacker buckets are unchanged). Padded
    lanes are poisoned exactly like the w4 packers. ``into`` as
    pack_records_w4_bytes'."""
    n = len(records)
    u1_bytes, u2_bytes, range_ok = _scalar_bitplanes(records, n)
    wraps = [rec.r + oracle.N < oracle.P for rec in records]
    qx_bytes = np.frombuffer(
        b"".join(rec.pubkey[0].to_bytes(32, "big") for rec in records),
        np.uint8).reshape(n, 32) if n else np.zeros((0, 32), np.uint8)
    r_bytes = np.frombuffer(
        b"".join(rec.r.to_bytes(32, "big") for rec in records),
        np.uint8).reshape(n, 32) if n else np.zeros((0, 32), np.uint8)
    rn_bytes = np.frombuffer(
        b"".join((rec.r + oracle.N if w else rec.r).to_bytes(32, "big")
                 for rec, w in zip(records, wraps)),
        np.uint8).reshape(n, 32) if n else np.zeros((0, 32), np.uint8)
    qy_bytes = np.frombuffer(
        b"".join(rec.pubkey[1].to_bytes(32, "big") for rec in records),
        np.uint8).reshape(n, 32) if n else np.zeros((0, 32), np.uint8)
    range_bad = None if range_ok is None else ~np.asarray(range_ok, bool)
    return _glv_pack_parts(
        u1_bytes, u2_bytes, qx_bytes, qy_bytes, r_bytes, rn_bytes, wraps,
        range_bad, bucket, into,
    )




def _verify_cpu_ecdsa(records: Sequence) -> np.ndarray:
    """ECDSA CPU lane: the native C++ scalar module (threaded via -par)
    when available, else the Python-int oracle. Differential parity is
    covered by tests/unit/test_native.py."""
    from .. import native

    if native.available():
        return np.array(native.ecdsa_verify_batch(records), dtype=bool)
    return np.array(
        [
            oracle.ecdsa_verify(rec.pubkey, rec.r, rec.s, rec.msg_hash)
            for rec in records
        ],
        dtype=bool,
    )


def _schnorr_oracle(records: Sequence) -> np.ndarray:
    """Per-lane Schnorr verify on the Python-int oracle — the accept/
    reject reference every MSM verdict must match."""
    STATS.schnorr_cpu_sigs += len(records)
    return np.array(
        [
            oracle.schnorr_verify(rec.pubkey, rec.r, rec.s, rec.msg_hash)
            for rec in records
        ],
        dtype=bool,
    )


def _verify_cpu(records: Sequence) -> np.ndarray:
    """CPU lane, algorithm-aware: ECDSA records take the native/oracle
    scalar path, Schnorr records the Schnorr oracle. Mixed batches are
    partitioned and re-merged in submission order (the deferral layer
    tags every SigCheckRecord with ``algo``; blob-path _LazyRecords and
    legacy callers without the field default to ECDSA)."""
    algos = [getattr(rec, "algo", "ecdsa") for rec in records]
    if "schnorr" not in algos:
        return _verify_cpu_ecdsa(records)
    out = np.zeros(len(records), bool)
    ecd = [i for i, a in enumerate(algos) if a != "schnorr"]
    sch = [i for i, a in enumerate(algos) if a == "schnorr"]
    if ecd:
        out[ecd] = _verify_cpu_ecdsa([records[i] for i in ecd])
    out[sch] = _schnorr_oracle([records[i] for i in sch])
    return out


_KAT = None


def _kat_records() -> tuple:
    """Known-answer probe lanes appended to every device batch: one
    signature that MUST verify and one that MUST NOT (same sig, different
    message). A device that inverts, zeroes, or fabricates the validity
    mask gets both polarities wrong-side and the batch is discarded before
    any verdict can see it (BatchHandle.result's KAT gate). Generated once
    from the Python-int oracle."""
    global _KAT
    if _KAT is None:
        import hashlib

        from ..script.interpreter import SigCheckRecord

        d = 0x1D3F2A9C5B7E6D4F8A1B2C3D4E5F60718293A4B5C6D7E8F9
        e = int.from_bytes(
            hashlib.sha256(b"bcp-supervised-dispatch-kat").digest(), "big"
        ) % oracle.N
        r, s = oracle.ecdsa_sign(d, e)
        pub = oracle.point_mul(d, oracle.G)
        good = SigCheckRecord(pub, r, s, e)
        bad = SigCheckRecord(pub, r, s, (e + 1) % oracle.N)
        _KAT = (good, bad)
    return _KAT


# ---- Schnorr MSM batch verification ----------------------------------------
#
# The kernel (ops/secp256k1.schnorr_msm_is_infinity, csrc/msm.cu) answers
# ONE bit per batch: does sum a_i R_i + sum (a_i e_i) P_i + ((n - sum a_i
# s_i) mod n) G land on the point at infinity. Trust around that bit, as
# the reference's:
#
#   accept side — a CANARY gate per verify session: the kernel must
#     accept a known-good batch AND reject that batch with a known-bad
#     sig appended before any real verdict is trusted. With the canary
#     green, a false accept needs the 2^-128 coefficient collision.
#   reject side — never the device's alone: a rejected batch BISECTS with
#     fresh coefficients per sub-batch; sub-batches of MSM_MIN_BATCH or
#     fewer settle on the per-lane Python oracle, so every False the
#     caller sees was produced by the oracle.
#   host prechecks — r/s range and the R = lift_x(r) existence test run
#     on the host and pre-reject without device work; the oracle rejects
#     exactly those (schnorr_verify accepts only when R'.x == r for a
#     finite R', which forces r^3 + 7 to be a residue, and its jacobi
#     gate matches lift_x's root).

_SCHNORR_KAT = None


def _schnorr_kat_records() -> tuple:
    """Known-answer Schnorr records for the MSM canary batches: one
    signature that MUST verify and one that MUST NOT (same sig, shifted
    message). Generated once from the Python-int oracle."""
    global _SCHNORR_KAT
    if _SCHNORR_KAT is None:
        import hashlib

        from ..script.interpreter import SigCheckRecord

        d = 0x5A7D1C9E3B8F6A2D4C1E8B7F9A3D5C6E8F1A2B4D6C8E9F1B3A5C7E9D2B4F6A8C
        d %= oracle.N
        e = int.from_bytes(
            hashlib.sha256(b"bcp-msm-batch-kat").digest(), "big"
        ) % oracle.N
        r, s = oracle.schnorr_sign(d, e)
        pub = oracle.point_mul(d, oracle.G)
        good = SigCheckRecord(pub, r, s, e, algo="schnorr")
        bad = SigCheckRecord(pub, r, s, (e + 1) % oracle.N, algo="schnorr")
        _SCHNORR_KAT = (good, bad)
    return _SCHNORR_KAT


def _msm_rng() -> random.Random:
    """Coefficient RNG for one verify session. Security rests on the
    coefficients being unpredictable to whoever crafted the signatures;
    os.urandom seeds each session. BCP_MSM_SEED pins the stream for
    deterministic drills and tests (never set in production)."""
    seed = os.environ.get("BCP_MSM_SEED")
    if seed is not None:
        return random.Random(int(seed, 0))
    return random.Random(int.from_bytes(os.urandom(16), "big"))


def _schnorr_precheck(rec):
    """Host-side pre-reject + R lift: the affine R = lift_x(r) for a
    structurally admissible record, None where the oracle is guaranteed
    to reject (range violation, unliftable r, missing pubkey)."""
    if rec.pubkey is None:
        return None
    if not (0 <= rec.r < oracle.P and 0 <= rec.s < oracle.N):
        return None
    return oracle.schnorr_lift_x(rec.r)


def _msm_bucket_for(m: int) -> int:
    for b in _MSM_BUCKETS:
        if m <= b:
            return b
    raise ValueError(f"MSM term count {m} exceeds the bucket ladder")


def _msm_pack(terms, bucket: int, into=None):
    """(x, y, scalar) Python-int terms -> the MSM kernel's byte matrices
    (xm, ym, inf8, km; inf8 uint8), padded to ``bucket`` with
    infinity-flagged zero-scalar lanes (they add nothing by construction).
    ``into``: the four arrays to fill in place (kept buffers; every lane is
    written), else new ones."""
    m = len(terms)
    xm = _zeros(into, 0, (bucket, 32))
    ym = _zeros(into, 1, (bucket, 32))
    km = _zeros(into, 3, (bucket, 32))
    inf8 = _ones(into, 2, bucket)
    xm[:m] = np.frombuffer(
        b"".join(x.to_bytes(32, "big") for x, _, _ in terms),
        np.uint8).reshape(m, 32)
    ym[:m] = np.frombuffer(
        b"".join(y.to_bytes(32, "big") for _, y, _ in terms),
        np.uint8).reshape(m, 32)
    km[:m] = np.frombuffer(
        b"".join(k.to_bytes(32, "big") for _, _, k in terms),
        np.uint8).reshape(m, 32)
    inf8[:m] = 0
    return xm, ym, inf8, km


def _msm_device_check(pairs, rng: random.Random) -> bool:
    """ONE batch-equation check on the device: ``pairs`` is a list of
    (record, lifted_R) with every record already through
    _schnorr_precheck. Draws FRESH random coefficients (bisection calls
    this per sub-batch — reusing coefficients across splits would let a
    crafted pair of forgeries cancel in one half). Returns the batch
    verdict. With CUDA selected and no card it raises KernelUnavailable.
    Its host work, kernel call and (for the canary batches) whole time
    are added to STATS.msm_host_s, msm_device_s and msm_canary_s."""
    from . import secp256k1 as dev

    INJECTOR.on_call(MSM_SITE)
    require_device("the Schnorr MSM kernel")
    t0 = time.monotonic()
    s_acc = 0
    terms = []
    for i, (rec, lift) in enumerate(pairs):
        # a_0 = 1 is safe (the adversary can't anticipate which sig lands
        # first in a sub-batch) and saves one 128-bit scalar ladder
        a = 1 if i == 0 else rng.getrandbits(128) | 1
        e = oracle.schnorr_challenge(rec.r, rec.pubkey, rec.msg_hash)
        s_acc = (s_acc + a * rec.s) % oracle.N
        terms.append((lift[0], lift[1], a))
        terms.append((rec.pubkey[0], rec.pubkey[1], (a * e) % oracle.N))
    terms.append((oracle.GX, oracle.GY, (oracle.N - s_acc) % oracle.N))
    bucket = _msm_bucket_for(len(terms))
    with dw.phase("ecdsa", "pack"):
        arrays = _msm_pack(terms, bucket)
    t1 = time.monotonic()
    out = _watched_kernel(_PW_MSM, bucket, arrays,
                          dev.schnorr_msm_is_infinity, split=None)
    t2 = time.monotonic()
    STATS.msm_host_s += t1 - t0
    STATS.msm_device_s += t2 - t1
    if _SCHNORR_KAT is not None and pairs[0][0] is _SCHNORR_KAT[0]:
        STATS.msm_canary_s += t2 - t0
    STATS.msm_dispatches += 1
    ok = bool(np.asarray(out)[0])
    if INJECTOR.should_poison(MSM_SITE):
        ok = not ok
    return ok


def _msm_verify_records(records: Sequence) -> np.ndarray:
    """Verdicts for a pure-Schnorr batch via the MSM batch check +
    bisection. Byte-identical to the per-lane oracle: pre-rejected lanes
    are oracle-guaranteed False, rejected batches funnel to the oracle,
    and accepted batches are wrong only on a 2^-128 coefficient
    collision (with the canary proving the kernel can tell good from bad
    at all). Raises on a device or canary failure — _dispatch_msm owns
    the supervision."""
    n = len(records)
    out = np.zeros(n, bool)
    lifts = [_schnorr_precheck(rec) for rec in records]
    live = [i for i in range(n) if lifts[i] is not None]
    if not live:
        return out
    rng = _msm_rng()

    # canary gate (see section comment): both polarities must be right
    # before any real verdict from this session is trusted
    kg, kb = _schnorr_kat_records()
    kgl = _schnorr_precheck(kg)
    kbl = _schnorr_precheck(kb)
    if (not _msm_device_check([(kg, kgl)], rng)
            or _msm_device_check([(kg, kgl), (kb, kbl)], rng)):
        STATS.msm_canary_failures += 1
        STATS.kat_failures += 1
        raise PoisonedOutput("ecdsa msm canary batches wrong")

    depth_max = 0

    def solve(idxs, depth: int) -> None:
        nonlocal depth_max
        depth_max = max(depth_max, depth)
        if len(idxs) <= MSM_MIN_BATCH:
            out[idxs] = _schnorr_oracle([records[i] for i in idxs])
            return
        if _msm_device_check([(records[i], lifts[i]) for i in idxs], rng):
            out[idxs] = True
            STATS.msm_batches_accepted += 1
            return
        STATS.msm_batches_rejected += 1
        STATS.msm_bisects += 1
        mid = len(idxs) // 2
        solve(idxs[:mid], depth + 1)
        solve(idxs[mid:], depth + 1)

    # chunk so M = 2n+1 stays inside the bucket ladder; each chunk is an
    # independent batch equation
    for s in range(0, len(live), MSM_MAX_RECORDS):
        solve(live[s:s + MSM_MAX_RECORDS], 0)
    STATS.msm_bisect_depth_max = max(STATS.msm_bisect_depth_max, depth_max)
    return out


def _raise_unless_msm_injected(e: Exception, poisoned: int) -> None:
    """The MSM rung hands a batch to the per-lane oracle only for a fault
    the harness injected: an InjectedFault (at ecdsa_msm or ecdsa), or a
    canary trip in an attempt whose verdicts poison-output flipped (the
    injector's ecdsa_msm poison count has moved past ``poisoned``, its
    value when the attempt began). Programming errors and a missing
    kernel re-raise as they are; anything else — a CUDA error, a failed
    launch, a canary trip nobody injected — raises KernelUnavailable."""
    if (isinstance(e, PoisonedOutput)
            and INJECTOR.poisoned.get(MSM_SITE, 0) > poisoned):
        return
    _raise_unless_injected(e, "the Schnorr MSM kernel (msm_run)")


def _dispatch_msm(records: Sequence, br) -> Optional[BatchHandle]:
    """Supervised MSM dispatch for a pure-Schnorr record list. EAGER
    (synchronous settle): the bisection ladder is verdict-driven, so the
    returned handle already carries the final verdicts. Returns None
    when every attempt failed by an injected fault (the caller owns the
    per-lane oracle); any other failure raises (_raise_unless_msm_injected)
    — the reference retries and then falls back for every failure."""
    boff = Backoff(base=br.cfg.backoff_base, maximum=1.0)
    last: Optional[BaseException] = None
    for attempt in range(br.cfg.retries + 1):
        try:
            poisoned = INJECTOR.poisoned.get(MSM_SITE, 0)
            INJECTOR.on_call("ecdsa")
            out = _msm_verify_records(records)
            br.record_success()
            return BatchHandle(len(records), cpu_ok=out)
        except (KeyboardInterrupt, SystemExit):
            raise
        except (NameError, AttributeError, UnboundLocalError):
            raise  # programming errors must not degrade silently
        except Exception as e:  # noqa: BLE001 — supervised boundary
            _raise_unless_msm_injected(e, poisoned)
            last = e
            if attempt < br.cfg.retries:
                time.sleep(boff.next())
    br.record_failure(last)
    br.note_fallback(len(records))
    STATS.msm_fallback_sigs += len(records)
    log_printf("schnorr msm dispatch failed (%s: %s) — per-lane oracle "
               "fallback for %d sig(s)", type(last).__name__,
               str(last)[:120], len(records))
    return None


def _dispatch_schnorr(records: Sequence, backend: str,
                      kernel: str | None) -> "BatchHandle":
    """Dispatch a pure-Schnorr record list: the MSM batch check when the
    msm kernel is selected and a device is worth dispatching to, else
    the per-lane oracle (the reference engine). An open ecdsa breaker
    sends the batch to the oracle only while a fault is armed at ecdsa or
    ecdsa_msm; otherwise it raises KernelUnavailable."""
    n = len(records)
    STATS.schnorr_sigs += n
    kern = kernel if kernel in ECDSA_KERNELS else active_kernel()
    use_device = kern == "msm" and (
        backend == "device"
        or (backend == "auto" and n >= CPU_FLOOR and _device_available())
    )
    if use_device:
        br = dispatch.breaker("ecdsa")
        if br.allow():
            handle = _dispatch_msm(records, br)
            if handle is not None:
                return handle
            STATS.fault_fallback_sigs += n
        else:
            if not (INJECTOR.armed_for("ecdsa")
                    or INJECTOR.armed_for(MSM_SITE)):
                raise KernelUnavailable(
                    "the ecdsa breaker is open and no fault is injected "
                    f"at ecdsa or {MSM_SITE}: {br.snapshot()}")
            br.note_fallback(n)
            STATS.fault_fallback_sigs += n
    STATS.cpu_fallback_sigs += n
    return BatchHandle(n, cpu_ok=_schnorr_oracle(records))


class _MergedHandle:
    """Mixed ECDSA/Schnorr dispatch: per-algorithm sub-handles re-merged
    into submission order at settle. Result is memoized like
    BatchHandle; _bucket mirrors the widest sub-dispatch so LanePacker's
    fill metering keeps working through mixed batches."""

    __slots__ = ("_n", "_parts", "_result", "_bucket")

    def __init__(self, n: int, parts):
        self._n = n
        self._parts = parts  # [(handle, submission indices), ...]
        self._bucket = max(
            (getattr(h, "_bucket", 0) for h, _ in parts), default=0)
        self._result = None

    def result(self) -> np.ndarray:
        if self._result is None:
            out = np.zeros(self._n, bool)
            for handle, idxs in self._parts:
                out[idxs] = handle.result()
            self._result = out
            self._parts = ()
        return self._result


def _device_available() -> bool:
    """True when dispatching to the port's device is worth it: always
    with CUDA selected — the device leg's require_device then raises
    KernelUnavailable when no card is found, so "auto" never carries on
    quietly on the CPU. With the CPU device selected the plain PyTorch
    version stands in for the kernel, and — as the reference does on a
    CPU backend — "auto" prefers the native C++ batch when it loaded.
    backend="device" always forces the device leg (the tests)."""
    if os.environ.get("BCP_NO_DEVICE"):
        return False
    if device().type == "cuda":
        return True
    from .. import native

    return not native.available()


def _host(x) -> np.ndarray:
    """A verdict plane (CUDA or CPU tensor, or numpy) on the host; for a
    CUDA tensor this is where the host waits for the kernel."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class BatchHandle:
    """An in-flight verify dispatch (pipeline overlap).

    The kernel launch is asynchronous: ``dispatch_batch`` returns with the
    kernel enqueued on the current CUDA stream, and the host keeps
    interpreting the next transactions' scripts while the card verifies.
    ``.result()`` copies the verdicts back (blocking) and finalizes stats.

    Supervision (ops/dispatch): device-path handles carry the records and
    the ecdsa breaker; a materialization error or a wrong known-answer
    lane at settle time counts a breaker failure and the verdict is a
    FRESH CPU re-verification of the real records — never a cached or
    fabricated mask."""

    __slots__ = ("_n", "_bucket", "_device_ok", "_cpu_ok", "_degen",
                 "_records", "_breaker", "_kat", "_recover", "_ctx",
                 "_poisoned")

    def __init__(self, n, bucket=0, device_ok=None, cpu_ok=None,
                 degen=None, records=None, breaker=None, kat=False,
                 recover=None, ctx=None, poisoned=False):
        self._n = n
        self._bucket = bucket
        self._device_ok = device_ok
        self._cpu_ok = cpu_ok
        self._degen = degen
        self._records = records
        self._breaker = breaker
        self._kat = kat
        self._recover = recover  # fast whole-batch CPU verdict (packed)
        # enqueue-side trace context: the settle span links back to the
        # span that dispatched this batch
        self._ctx = ctx
        # the harness inverted this batch's mask at dispatch (a GLV leg's
        # poison-output drill)
        self._poisoned = poisoned

    def _device_failed(self, err: BaseException) -> np.ndarray:
        """Settle-time device failure: breaker bookkeeping + CPU re-verify
        of the real lanes (the verdict that reaches the caller is computed
        by the reference engine, not recycled device output)."""
        if self._breaker is not None:
            self._breaker.record_failure(err)
            self._breaker.note_fallback(self._n)
        STATS.cpu_fallback_sigs += self._n
        STATS.fault_fallback_sigs += self._n
        log_printf("ecdsa device batch failed at settle (%s: %s) — CPU "
                   "re-verify of %d sig(s)",
                   type(err).__name__, str(err)[:120], self._n)
        if self._recover is not None:
            out = self._recover()
        else:
            out = _verify_cpu([self._records[i] for i in range(self._n)])
        self._degen = None
        self._records = None
        self._cpu_ok = np.asarray(out, dtype=bool)
        return self._cpu_ok

    def result(self) -> np.ndarray:
        if self._device_ok is None:
            return self._cpu_ok
        t0 = time.monotonic()
        try:
            with tm.span("ecdsa.settle", parent=self._ctx, lanes=self._n,
                         bucket=self._bucket):
                ok = _host(self._device_ok)  # blocks until the card is done
                degen = (_host(self._degen) if self._degen is not None
                         else None)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # device died between enqueue and settle
            STATS.in_flight = max(0, STATS.in_flight - 1)
            _IN_FLIGHT_G.set(STATS.in_flight)
            self._device_ok = None
            raise_kernel_fault(e, "the ecdsa kernel")
            return self._device_failed(e)
        # device_seconds counts only the blocking wait — when the overlap
        # is doing its job the host hid the latency and this is near zero
        wait = time.monotonic() - t0
        STATS.device_seconds += wait
        _SETTLE_H.observe(wait)
        dw.note_transfer("ecdsa", "d2h", int(ok.nbytes), seconds=wait)
        dw.note_phase("ecdsa", "fetch", wait)
        STATS.in_flight = max(0, STATS.in_flight - 1)
        _IN_FLIGHT_G.set(STATS.in_flight)
        self._device_ok = None
        ok = np.asarray(ok, dtype=bool)
        if INJECTOR.should_poison("ecdsa"):
            ok = ~ok
            self._poisoned = True
        if self._kat:
            # known-answer gate: lanes n and n+1 are the good/bad probe
            # records appended at dispatch; both polarities must be right
            # before ANY lane of this batch is trusted
            if not bool(ok[self._n]) or bool(ok[self._n + 1]):
                STATS.kat_failures += 1
                if not self._poisoned:
                    # a kernel that lies with no fault injected is broken
                    raise KernelUnavailable(
                        "the ecdsa kernel's known-answer lanes came back "
                        "wrong with no fault injected")
                return self._device_failed(
                    PoisonedOutput("ecdsa known-answer lanes wrong"))
        out = ok[: self._n].copy()
        if degen is not None:
            # degenerate lanes (adversarial H == 0 collisions) carry
            # garbage — re-verify them on the scalar CPU path. The
            # kernel's verdict for those lanes is NEVER trusted.
            idxs = np.nonzero(np.asarray(degen, bool)[: self._n])[0]
            if idxs.size:
                STATS.degenerate_rechecks += int(idxs.size)
                redo = _verify_cpu([self._records[i] for i in idxs])
                out[idxs] = redo
            self._degen = None
        if self._records is not None:
            # reject-side host confirmation: a device False is never
            # allowed to reject a block on its own (the KAT lanes can't
            # see a single corrupted real lane). Honest-valid blocks have
            # zero False lanes, so this is free in the common case.
            bad = np.nonzero(~out)[0]
            if bad.size:
                STATS.reject_confirm_sigs += int(bad.size)
                out[bad] = _verify_cpu([self._records[i] for i in bad])
        if self._breaker is not None:
            self._breaker.record_success()
        self._records = None
        self._cpu_ok = out
        return self._cpu_ok


def dispatch_batch(records: Sequence, backend: str = "auto",
                   kernel: str | None = None) -> BatchHandle:
    """Enqueue a verify batch without waiting; returns a BatchHandle.

    backend: "auto" (device if available and batch >= CPU_FLOOR),
    "device" (force), "cpu" (force oracle — synchronous).
    kernel: per-call override of the device verify kernel ("glv", "w4"
    or "msm"); None uses active_kernel() (the -ecdsakernel process
    default). "msm" sends the Schnorr lanes to the Pippenger batch check
    (eager: the handle carries the final verdicts); ECDSA lanes under it
    take the GLV ladder.

    The device leg is supervised (ops/dispatch): the ecdsa circuit breaker
    gates it, bounded retries absorb transient dispatch errors, and a
    failed dispatch degrades to a fresh CPU verification of the same
    records — the verdict the caller sees is never dropped or fabricated.
    A kernel that cannot be built or launched raises KernelUnavailable."""
    if not records:
        return BatchHandle(0, cpu_ok=np.zeros(0, bool))
    n = len(records)
    algos = [getattr(r, "algo", "ecdsa") for r in records]
    if any(a == "schnorr" for a in algos):
        if all(a == "schnorr" for a in algos):
            return _dispatch_schnorr(records, backend, kernel)
        e_idx = [i for i, a in enumerate(algos) if a != "schnorr"]
        s_idx = [i for i, a in enumerate(algos) if a == "schnorr"]
        return _MergedHandle(n, [
            (dispatch_batch([records[i] for i in e_idx], backend,
                            kernel=kernel), e_idx),
            (_dispatch_schnorr([records[i] for i in s_idx], backend,
                               kernel), s_idx),
        ])
    use_device = backend == "device" or (
        backend == "auto"
        and n >= CPU_FLOOR
        and _device_available()
    )
    if use_device:
        br = dispatch.breaker("ecdsa")
        if br.allow():
            handle = _dispatch_device(records, br, kernel=kernel)
            if handle is not None:
                return handle
            # device leg failed after retries (breaker already charged):
            # fresh CPU re-verification, counted as fault fallback
            STATS.fault_fallback_sigs += n
        else:
            br.note_fallback(n)
            STATS.fault_fallback_sigs += n
    STATS.cpu_fallback_sigs += n
    return BatchHandle(n, cpu_ok=_verify_cpu(records))


# errors that must surface, never degrade to the CPU engine: programming
# errors (a NameError in the pack path must not hide behind a green CPU
# fallback forever) and a kernel that cannot be built or launched
_NEVER_DEGRADE = (NameError, AttributeError, UnboundLocalError,
                  KernelUnavailable)


def _dispatch_device(records: Sequence, br,
                     kernel: str | None = None) -> Optional[BatchHandle]:
    """One supervised device enqueue attempt (with retries). Returns None
    when every attempt failed — the caller owns the CPU fallback. Two
    known-answer lanes (good + bad signature) ride after the real records
    so BatchHandle.result can detect a lying validity mask (the KAT lanes
    ride — and therefore exercise — whichever kernel actually ran).

    Kernel chain: GLV with the device split -> GLV from the host split ->
    w4 (buckets that are multiples of 1024 take the byte entry, the small
    buckets 32 and 128 the plane entry) -> the bit ladder. The w4 rung
    runs only when pallas_enabled(); otherwise the bit ladder
    (ecdsa_verify_batch_jit, no degen plane) runs at the plane buckets, as
    in the reference. A GLV leg steps down only for a fault the harness
    injected (_note_glv_dev_failure, _note_glv_failure)."""
    from . import secp256k1 as dev

    wire = list(records) + list(_kat_records())
    boff = Backoff(base=br.cfg.backoff_base, maximum=1.0)
    last: Optional[BaseException] = None
    if kernel is not None and kernel not in ECDSA_KERNELS:
        set_kernel(kernel)  # raises: an unknown kernel
    kern = kernel or active_kernel()
    if kern == "msm":
        # the MSM batch equation verifies Schnorr sigs only; ECDSA lanes
        # under -ecdsakernel=msm take the GLV ladder
        kern = "glv"
    ctx = tm.trace_context()
    for attempt in range(br.cfg.retries + 1):
        try:
            INJECTOR.on_call("ecdsa")
            require_device("the ecdsa device leg")
            device_ok = degen = None
            poisoned = False
            if kern == "glv" and glv_enabled():
                # floor 1024: the GLV legs take the byte ladder's buckets
                bucket = max(1024, _bucket_for(len(wire), pallas=True))
                device_ok, degen, poisoned = _glv_ladder(
                    bucket, lambda: pack_records_w4_bytes(wire, bucket),
                    lambda: pack_records_glv(wire, bucket))
            if device_ok is None and pallas_enabled():
                bucket = _bucket_for(len(wire), pallas=True)
                if bucket % 1024 == 0:
                    with dw.phase("ecdsa", "pack"):
                        arrays = pack_records_w4_bytes(wire, bucket)
                    device_ok, degen = _watched_kernel(
                        _PW_W4_BYTES, bucket, arrays,
                        dev.ecdsa_verify_batch_pallas_w4_bytes)
                else:
                    with dw.phase("ecdsa", "pack"):
                        arrays = pack_records_w4(wire, bucket)
                    device_ok, degen = _watched_kernel(
                        _PW_W4, bucket, arrays,
                        dev.ecdsa_verify_batch_pallas_w4, split=None)
            if device_ok is None:
                # the bit ladder (BCP_SECP_PALLAS=0): pack_records' planes
                # at the plane buckets; every add complete, no degen plane
                bucket = _bucket_for(len(wire), pallas=False)
                with dw.phase("ecdsa", "pack"):
                    arrays = pack_records(wire, bucket)
                device_ok = _watched_kernel(
                    _PW_XLA, bucket, arrays, dev.ecdsa_verify_batch_jit,
                    split=None)
            _note_device_dispatch(len(records), bucket)
            return BatchHandle(len(records), bucket, device_ok, degen=degen,
                               records=wire, breaker=br, kat=True, ctx=ctx,
                               poisoned=poisoned)
        except (KeyboardInterrupt, SystemExit):
            raise
        except _NEVER_DEGRADE:
            raise
        except Exception as e:  # noqa: BLE001 — supervised boundary
            raise_kernel_fault(e, "the ecdsa kernel")
            last = e
            if attempt < br.cfg.retries:
                time.sleep(boff.next())
    br.record_failure(last)
    br.note_fallback(len(records))
    log_printf("ecdsa device dispatch failed (%s: %s) — CPU fallback for "
               "%d sig(s)", type(last).__name__, str(last)[:120],
               len(records))
    return None


def _glv_ladder(bucket: int, dev_arrays: Callable[[], list],
                host_arrays: Callable[[], list]) -> tuple:
    """The GLV rungs of one supervised attempt, shared by _dispatch_device
    and _dispatch_packed_device: the device-split kernel on
    ``dev_arrays()`` (the w4 byte matrices), then, only after a fault the
    harness injected there, the host-split kernel on ``host_arrays()``.
    Each leg runs behind the reference's gate: the device split behind
    glv_dev_enabled(), the host split behind glv_enabled(). Returns
    (device_ok, degen, poisoned); device_ok is None when injected faults
    took both rungs down (the caller steps down to w4)."""
    from . import secp256k1 as dev

    if glv_dev_enabled():
        try:
            # device-split leg: the host pack is the w4 byte emit only;
            # the lattice split runs in the kernel
            INJECTOR.on_call(GLV_DEV_SITE)
            INJECTOR.on_call(GLV_SITE)
            t0 = time.monotonic()
            with dw.phase("ecdsa", "pack"):
                arrays = dev_arrays()
            dt = time.monotonic() - t0
            STATS.glv_emit_s += dt
            _STAGE_H.labels(stage="emit").observe(dt)
            t0 = time.monotonic()
            device_ok, degen = _watched_kernel(
                _PW_GLV_DEV, bucket, arrays, dev.ecdsa_verify_batch_glv_dev)
            STATS.glv_dispatch_s += time.monotonic() - t0
            poisoned = (INJECTOR.should_poison(GLV_DEV_SITE)
                        or INJECTOR.should_poison(GLV_SITE))
            if poisoned:
                device_ok = ~device_ok
            STATS.glv_dispatches += 1
            STATS.glv_dev_dispatches += 1
            return device_ok, degen, poisoned
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            _note_glv_dev_failure(e)
    if not glv_enabled():
        return None, None, False
    try:
        # host-split leg
        INJECTOR.on_call(GLV_SITE)
        arrays = host_arrays()
        t0 = time.monotonic()
        device_ok, degen = _watched_kernel(
            _PW_GLV, bucket, arrays, dev.ecdsa_verify_batch_glv)
        STATS.glv_dispatch_s += time.monotonic() - t0
        poisoned = INJECTOR.should_poison(GLV_SITE)
        if poisoned:
            device_ok = ~device_ok
        STATS.glv_dispatches += 1
        return device_ok, degen, poisoned
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        _note_glv_failure(e)
    return None, None, False


def _raise_unless_injected(e: Exception, what: str) -> None:
    """A GLV leg's failure steps down a rung only when the harness
    injected it (an InjectedFault); programming errors and a missing
    kernel re-raise as they are, and everything else — a CUDA error, a
    bad launch, a failed pack — raises KernelUnavailable."""
    if isinstance(e, _NEVER_DEGRADE):
        raise e
    raise_kernel_fault(e, what)
    if not isinstance(e, InjectedFault):
        raise KernelUnavailable(
            f"{what} failed: {type(e).__name__}: {e}") from e


def _note_glv_dev_failure(e: Exception) -> None:
    """Device-split leg failure: an injected fault steps down to the host
    split (same supervised attempt); any other failure raises."""
    _raise_unless_injected(e, "the GLV device-split kernel (glv_dev_verify)")
    STATS.glv_dev_fallbacks += 1
    log_printf("glv device-decompose leg failed (%s) — host decompose "
               "fallback", f"{type(e).__name__}: {e}"[:200])


def _note_glv_failure(e: Exception) -> None:
    """GLV-leg failure: an injected fault steps down to the w4 kernel
    (same supervised attempt); any other failure raises."""
    _raise_unless_injected(e, "the GLV kernel (glv_verify)")
    STATS.glv_fallbacks += 1
    log_printf("glv ECDSA kernel failed (%s) — w4 fallback",
               f"{type(e).__name__}: {e}"[:200])


def verify_batch(records: Sequence, backend: str = "auto",
                 kernel: str | None = None) -> np.ndarray:
    """Verify all records synchronously; returns (len(records),) bool."""
    return dispatch_batch(records, backend, kernel=kernel).result()


# ---------------------------------------------------------------------------
# Cross-block lane packer — the pipelined IBD engine's aggregation layer.
#
# A single mainnet-shaped block rarely fills a padded bucket, so per-block
# dispatch pays padding (and, on a remote device, a whole round trip) for
# partially-filled lanes. The packer aggregates deferred records from
# MULTIPLE in-flight blocks (the ChainstateManager settle horizon) and
# dispatches only full buckets; each contributing block gets its own
# SigBatchFuture whose lanes map back into the shared BatchHandles, so
# failure attribution and settle order stay per-block. Supervision is
# unchanged: every underlying dispatch is the breaker/KAT-gated
# dispatch_batch, and BatchHandle.result() is memoized, so many futures
# can share one handle safely.
# ---------------------------------------------------------------------------


class SigBatchFuture:
    """One block's slice of the cross-block packed dispatches. result()
    returns a bool verdict per record in submission order; it forces a
    packer flush if any of this block's records are still undispatched
    (settling the horizon's oldest block must never deadlock on lanes
    parked behind it)."""

    __slots__ = ("_packer", "_segments", "_queued", "_result", "_tag")

    def __init__(self, packer):
        self._packer = packer
        self._segments = []  # (handle-wrapper, start, end), dispatch order
        self._queued = 0     # records still in the packer's pending buffer
        self._result = None
        self._tag = None     # speculation-tree branch attribution

    def result(self) -> np.ndarray:
        if self._result is None:
            if self._queued:
                self._packer.flush_for(self)
            parts = [self._packer._settle(h)[s:e]
                     for h, s, e in self._segments]
            self._result = (np.concatenate(parts) if parts
                            else np.zeros(0, bool))
            self._segments = []
        return self._result

    def drain(self) -> None:
        """Abort-path settle: records still parked in the packer's pending
        buffer are DISCARDED (verifying doomed lanes — up to a whole
        horizon's worth on an unwind — would be pure waste), while
        already-dispatched segments are materialized so STATS.in_flight
        and a breaker probe riding one of them never strand. Verdicts are
        ignored."""
        try:
            if self._queued:
                self._packer.discard(self)
            for pd, _s, _e in self._segments:
                try:
                    self._packer._settle(pd)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:  # noqa: BLE001 — abort-path drain
                    pass
        finally:
            self._segments = []
            if self._result is None:
                self._result = np.zeros(0, bool)


class _PackedDispatch:
    """A shared BatchHandle plus the overlap-metering timestamps."""

    __slots__ = ("handle", "t_enqueue", "settled")

    def __init__(self, handle, t_enqueue):
        self.handle = handle
        self.t_enqueue = t_enqueue
        self.settled = False


class LanePacker:
    """Aggregate SigCheckRecords across blocks into full padded buckets.

    ``lanes`` is the dispatch size; the default (2046) fills the 2048
    bucket exactly once the supervised dispatch appends its 2 known-answer
    lanes. When the ecdsa breaker is not healthy the packer stops
    aggregating (target 0): every add flushes immediately, because with
    the device path open all lanes go to the CPU engine and aggregation
    would only add settle latency."""

    # branch-attribution bound: the per-tag lane tallies must not grow
    # without limit under a fork storm minting fresh branch tags
    MAX_TAGS = 64

    def __init__(self, backend: str = "auto", lanes: int = 2046,
                 kernel: str | None = None):
        self.backend = backend
        self.lanes = lanes
        self.kernel = kernel  # per-packer -ecdsakernel override (wiring)
        self._pending: list = []           # records awaiting dispatch
        self._pending_futs: list = []      # (future, count) per add(), order
        self.stats = {
            "dispatches": 0, "lanes_real": 0, "lanes_padded": 0,
            "lanes_discarded": 0, "blocks": 0,
            "inflight_s": 0.0, "blocked_s": 0.0,
        }
        # speculation-tree branch attribution: lanes added /
        # discarded per branch tag — competing branches share buckets,
        # this is the per-branch split of the shared device work
        self.branch_lanes: dict[str, int] = {}
        self.branch_discards: dict[str, int] = {}

    def _tag_note(self, table: dict, tag: str | None, n: int) -> None:
        if tag is None or n <= 0:
            return
        if tag not in table and len(table) >= self.MAX_TAGS:
            table.pop(next(iter(table)))  # oldest tag out
        table[tag] = table.get(tag, 0) + n

    def _target_lanes(self) -> int:
        if self.backend == "cpu":
            return self.lanes  # no padding concept, but batching still wins
        if not dispatch.breaker("ecdsa").healthy():
            return 0  # device path distrusted: no point holding lanes back
        return self.lanes

    def add(self, records: Sequence, tag: str | None = None
            ) -> SigBatchFuture:
        """Enqueue one block's fresh (sigcache-missed) records; returns the
        block's future. Dispatches fire whenever a full bucket is banked.
        ``tag`` attributes the lanes to a speculation-tree branch."""
        fut = SigBatchFuture(self)
        fut._queued = len(records)
        fut._tag = tag
        self._tag_note(self.branch_lanes, tag, len(records))
        if records:
            self._pending.extend(records)
            self._pending_futs.append((fut, len(records)))
        target = self._target_lanes()
        if target <= 0:
            self.flush()  # device distrusted: don't hold lanes back
        else:
            while len(self._pending) >= target:
                self._dispatch(target)
        return fut

    def flush(self) -> None:
        """Dispatch everything still pending (sub-bucket tail included)."""
        while self._pending:
            self._dispatch(min(len(self._pending), max(self.lanes, 1)))

    def discard(self, fut: SigBatchFuture) -> None:
        """Drop ``fut``'s still-undispatched records from the pending
        buffer (abort path — see SigBatchFuture.drain)."""
        if fut._queued <= 0:
            return
        off = 0
        for i, (f, count) in enumerate(self._pending_futs):
            if f is fut:
                del self._pending[off:off + count]
                self._pending_futs.pop(i)
                self.stats["lanes_discarded"] += count
                self._tag_note(self.branch_discards, fut._tag, count)
                fut._queued = 0
                return
            off += count

    def flush_for(self, fut: SigBatchFuture) -> None:
        """Dispatch only the pending PREFIX up to (and including) ``fut``'s
        records — settling the horizon's oldest block must not also ship
        younger blocks' sub-bucket tails, which can keep aggregating
        toward full buckets (lanes queue FIFO, so the prefix is exactly
        what fut needs)."""
        while fut._queued > 0 and self._pending:
            self._dispatch(min(len(self._pending), max(self.lanes, 1)))

    def _dispatch(self, n: int) -> None:
        batch = self._pending[:n]
        del self._pending[:n]
        try:
            handle = dispatch_batch(batch, backend=self.backend,
                                    kernel=self.kernel)
        except (KeyboardInterrupt, SystemExit, *_NEVER_DEGRADE):
            raise  # programming errors and a missing kernel surface
        except Exception:
            # same last-line-of-defense contract as the per-block verifier:
            # a supervision-layer crash must not drop the batch
            STATS.fault_fallback_sigs += len(batch)
            handle = dispatch_batch(batch, backend="cpu")
        pd = _PackedDispatch(handle, time.monotonic())
        st = self.stats
        st["dispatches"] += 1
        st["lanes_real"] += len(batch)
        _PACKER_FLUSH_H.observe(len(batch))
        # padding booked from the handle's ACTUAL bucket (0 = the dispatch
        # took the CPU lane, which has no padding concept); the 2 KAT lanes
        # ride every device batch and are excluded from the fill metric
        bucket = getattr(handle, "_bucket", 0)
        if bucket:
            st["lanes_padded"] += max(0, bucket - len(batch) - 2)
        total = st["lanes_real"] + st["lanes_padded"]
        if total:
            _LANE_FILL_G.set(round(100.0 * st["lanes_real"] / total, 2))
        # carve the dispatched records back into per-block segments
        pos = 0
        consumed = []
        for i, (fut, count) in enumerate(self._pending_futs):
            take = min(count, n - pos)
            if take <= 0:
                break
            fut._segments.append((pd, pos, pos + take))
            fut._queued -= take
            pos += take
            if take == count:
                consumed.append(i)
                st["blocks"] += 1
            else:
                self._pending_futs[i] = (fut, count - take)
        for i in reversed(consumed):
            self._pending_futs.pop(i)

    def _settle(self, pd: _PackedDispatch) -> np.ndarray:
        """Settle a shared dispatch (first consumer pays the blocking wait
        and the overlap metering; BatchHandle memoizes for the rest)."""
        if pd.settled:
            return pd.handle.result()
        t0 = time.monotonic()
        out = pd.handle.result()
        now = time.monotonic()
        pd.settled = True
        self.stats["blocked_s"] += now - t0
        self.stats["inflight_s"] += now - pd.t_enqueue
        return out

    def snapshot(self) -> dict:
        st = dict(self.stats)
        total = st["lanes_real"] + st["lanes_padded"]
        st["lane_fill_pct"] = round(100.0 * st["lanes_real"] / total, 2) \
            if total else 100.0
        # fraction of dispatched-batch lifetime the host spent NOT blocked
        # on settle — >0 means the pipeline actually hid device latency
        # (on a synchronous CPU backend the verify cost lands at enqueue,
        # inside the scan leg, and this reads as fully hidden)
        st["overlap_fraction"] = round(
            1.0 - st["blocked_s"] / st["inflight_s"], 4) \
            if st["inflight_s"] > 0 else 0.0
        st["pending_lanes"] = len(self._pending)
        st["branch_lanes"] = dict(self.branch_lanes)
        st["branch_discards"] = dict(self.branch_discards)
        return st


# ---------------------------------------------------------------------------
# Blob-level dispatch — the native connect engine's sigscan
# (native/connect.cpp) emits (pub64, r||s, msg, rn, wrap) byte blobs; this
# entry feeds them straight into the byte kernels (or the native
# threaded CPU verify) with zero per-record Python-int work. The record-level
# dispatch_batch above remains the generic path (script interpreter output).
# ---------------------------------------------------------------------------

class _LazyRecords:
    """SigCheckRecord view over packed blobs, materialized per index — only
    degenerate-lane rechecks (rare) ever touch it."""

    __slots__ = ("pub", "rs", "msg")

    def __init__(self, pub: np.ndarray, rs: np.ndarray, msg: np.ndarray):
        self.pub = pub
        self.rs = rs
        self.msg = msg

    def __getitem__(self, i: int):
        from ..script.interpreter import SigCheckRecord

        pub = self.pub[i].tobytes()
        rs = self.rs[i].tobytes()
        return SigCheckRecord(
            (int.from_bytes(pub[:32], "big"), int.from_bytes(pub[32:], "big")),
            int.from_bytes(rs[:32], "big"), int.from_bytes(rs[32:], "big"),
            int.from_bytes(self.msg[i].tobytes(), "big"),
        )


def records_to_blobs(records: Sequence):
    """Pack script-interpreter SigCheckRecords into the blob layout so the
    occasional generic-path record can join a packed dispatch. Also emits
    rn/wrap (the x-wraparound candidate gate)."""
    n = len(records)
    pub = np.frombuffer(
        b"".join(r.pubkey[0].to_bytes(32, "big") + r.pubkey[1].to_bytes(32, "big")
                 for r in records), np.uint8).reshape(n, 64)
    rs = np.frombuffer(
        b"".join((r.r % (1 << 256)).to_bytes(32, "big")
                 + (r.s % (1 << 256)).to_bytes(32, "big")
                 for r in records), np.uint8).reshape(n, 64)
    msg = np.frombuffer(
        b"".join((r.msg_hash % (1 << 256)).to_bytes(32, "big")
                 for r in records), np.uint8).reshape(n, 32)
    wraps = [r.r + oracle.N < oracle.P for r in records]
    rn = np.frombuffer(
        b"".join((r.r + oracle.N if w else r.r).to_bytes(32, "big")
                 for r, w in zip(records, wraps)), np.uint8).reshape(n, 32)
    return pub, rs, msg, rn, np.asarray(wraps, np.uint8)


# below this lane count the device round trip loses to the threaded native
# CPU verify even on real hardware (dispatch+transfer latency)
PACKED_DEVICE_FLOOR = 512


def dispatch_packed(pub: np.ndarray, rs: np.ndarray, msg: np.ndarray,
                    rn: np.ndarray, wrap: np.ndarray,
                    backend: str = "auto") -> BatchHandle:
    """Enqueue a packed verify batch: pub (n,64), rs (n,64), msg (n,32),
    rn (n,32), wrap (n,) — all uint8, big-endian fields, caller-validated
    ranges (1 <= r,s < N; pubkey on-curve affine). Device leg is breaker-
    supervised like dispatch_batch (same KAT lanes, same CPU re-verify on
    failure)."""
    from .. import native

    n = len(msg)
    if n == 0:
        return BatchHandle(0, cpu_ok=np.zeros(0, bool))
    use_device = backend == "device" or (
        backend == "auto" and n >= PACKED_DEVICE_FLOOR and _device_available()
    )
    if not use_device and native.available():
        return _packed_cpu_handle(pub, rs, msg, n)
    # the packed device leg needs a byte kernel: GLV, or w4 while
    # pallas_enabled(); otherwise (BCP_SECP_PALLAS=0 under w4 or msm) the
    # blobs take the record route, to the bit ladder
    packed_ok = pallas_enabled() or (
        active_kernel() == "glv" and glv_enabled()
    )
    if not (use_device and packed_ok):
        # the record-level path (the bit ladder, or, with no native
        # library, the Python-int oracle) keeps one source of truth
        recs = _LazyRecords(pub, rs, msg)
        return dispatch_batch([recs[i] for i in range(n)], backend=backend)

    br = dispatch.breaker("ecdsa")
    if not br.allow():
        br.note_fallback(n)
        STATS.fault_fallback_sigs += n
        return _packed_cpu_handle(pub, rs, msg, n)
    handle = _dispatch_packed_device(pub, rs, msg, rn, wrap, n, br)
    if handle is None:
        STATS.fault_fallback_sigs += n
        return _packed_cpu_handle(pub, rs, msg, n)
    return handle


def _packed_cpu_handle(pub, rs, msg, n: int) -> BatchHandle:
    """CPU verdict for a packed batch (native threaded verify when the
    library loaded, Python-int oracle otherwise)."""
    from .. import native

    STATS.cpu_fallback_sigs += n
    if native.available():
        ok = native.ecdsa_verify_batch_blobs(
            pub.tobytes(), rs.tobytes(), msg.tobytes(), n)
        return BatchHandle(n, cpu_ok=np.asarray(ok, bool))
    recs = _LazyRecords(pub, rs, msg)
    return BatchHandle(n, cpu_ok=_verify_cpu([recs[i] for i in range(n)]))


def _dispatch_packed_device(pub, rs, msg, rn, wrap, n: int,
                            br) -> Optional[BatchHandle]:
    """Supervised packed enqueue (retries + KAT lanes) down the ladder of
    _dispatch_device (GLV device split -> GLV host split -> the w4 byte
    entry) under the process default kernel: the GLV legs run only under
    "glv", as the reference gates them, so "w4" and "msm" start at the w4
    byte entry; None when every attempt failed. As in the reference, the
    w4 byte entry is the rung below GLV here whatever pallas_enabled()
    says (dispatch_packed sends the blobs here with Pallas off only under
    GLV, so only injected faults on both GLV rungs reach it then)."""
    from .. import native
    from . import secp256k1 as dev

    # KAT probe lanes appended after the real records (blob layout)
    kpub, krs, kmsg, krn, kwrap = records_to_blobs(list(_kat_records()))
    pub2 = np.concatenate([pub, kpub])
    rs2 = np.concatenate([rs, krs])
    msg2 = np.concatenate([msg, kmsg])
    rn2 = np.concatenate([rn, krn])
    wrap2 = np.concatenate([np.asarray(wrap, np.uint8), kwrap])
    m = n + 2
    bucket = max(1024, _bucket_for(m, pallas=True))

    def pad(mat: np.ndarray, width: int) -> np.ndarray:
        out = np.zeros((bucket, width), np.uint8)
        out[:m] = mat
        return out

    boff = Backoff(base=br.cfg.backoff_base, maximum=1.0)
    last: Optional[BaseException] = None
    ctx = tm.trace_context()  # settle-span parent (see _dispatch_device)
    for attempt in range(br.cfg.retries + 1):
        try:
            INJECTOR.on_call("ecdsa")
            require_device("the ecdsa device leg")
            # u1/u2 via the threaded native modular-inverse leg;
            # Python-int loop only if the native library is missing
            if native.available():
                u1_blob, u2_blob, ok = native.ecdsa_precompute_blobs(
                    rs2.tobytes(), msg2.tobytes(), m)
                u1 = np.frombuffer(u1_blob, np.uint8).reshape(m, 32)
                u2 = np.frombuffer(u2_blob, np.uint8).reshape(m, 32)
                range_bad = ~np.asarray(ok, bool)
            else:
                recs = _LazyRecords(pub2, rs2, msg2)
                scalars = decompose_scalars([recs[i] for i in range(m)])
                u1 = np.frombuffer(
                    b"".join(a.to_bytes(32, "big") for a, _ in scalars),
                    np.uint8).reshape(m, 32)
                u2 = np.frombuffer(
                    b"".join(b.to_bytes(32, "big") for _, b in scalars),
                    np.uint8).reshape(m, 32)
                range_bad = np.zeros(m, bool)
            q_inf = np.ones(bucket, np.uint8)
            q_inf[:m] = range_bad.astype(np.uint8)
            wrap8 = np.zeros(bucket, np.uint8)
            wrap8[:m] = wrap2

            def byte_arrays() -> list:
                # the byte matrices of the device-split and w4 entries
                return [pad(u1, 32), pad(u2, 32), pad(pub2[:, :32], 32),
                        pad(pub2[:, 32:], 32), q_inf, pad(rs2[:, :32], 32),
                        pad(rn2, 32), wrap8]

            device_ok = degen = None
            poisoned = False
            # the reference's gate: only -ecdsakernel=glv takes the GLV
            # legs here; w4 and msm send packed blobs to the w4 byte rung
            if active_kernel() == "glv" and glv_enabled():
                device_ok, degen, poisoned = _glv_ladder(
                    bucket, byte_arrays, lambda: _glv_pack_parts(
                        u1, u2, pub2[:, :32], pub2[:, 32:], rs2[:, :32],
                        rn2, wrap2.astype(bool), range_bad, bucket))
            if device_ok is None:
                with dw.phase("ecdsa", "pack"):
                    arrays = byte_arrays()
                device_ok, degen = _watched_kernel(
                    _PW_W4_BYTES, bucket, arrays,
                    dev.ecdsa_verify_batch_pallas_w4_bytes)
            _note_device_dispatch(n, bucket)

            def recover() -> np.ndarray:
                # settle-time failure on a packed batch: the native
                # threaded verify over the original blobs
                if native.available():
                    return np.asarray(native.ecdsa_verify_batch_blobs(
                        pub.tobytes(), rs.tobytes(), msg.tobytes(), n),
                        bool)
                recs = _LazyRecords(pub, rs, msg)
                return _verify_cpu([recs[i] for i in range(n)])

            return BatchHandle(n, bucket, device_ok, degen=degen,
                               records=_LazyRecords(pub2, rs2, msg2),
                               breaker=br, kat=True, recover=recover,
                               ctx=ctx, poisoned=poisoned)
        except (KeyboardInterrupt, SystemExit):
            raise
        except _NEVER_DEGRADE:
            raise
        except Exception as e:  # noqa: BLE001 — supervised boundary
            raise_kernel_fault(e, "the ecdsa kernel")
            last = e
            if attempt < br.cfg.retries:
                time.sleep(boff.next())
    br.record_failure(last)
    br.note_fallback(n)
    log_printf("ecdsa packed device dispatch failed (%s: %s) — CPU "
               "fallback for %d sig(s)", type(last).__name__,
               str(last)[:120], n)
    return None
