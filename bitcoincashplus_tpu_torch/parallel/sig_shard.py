"""Multi-device signature batch sharding (P1 in SURVEY.md §3.2).

Port of the reference's parallel/sig_shard.py. The signature-batch axis
is embarrassingly parallel: the B lanes are cut into one row block per
shard of the layout (parallel/mesh.py), and each shard is one launch of a
kernel the port already has, on that shard's rows alone (its own bucket,
so the launch tables ``ECDSA_LAUNCH`` and ``GLV_LAUNCH`` pick by the
shard's lanes, not the batch's):

- ``_sharded_glv_dev`` (the reference's ``_sharded_glv_dev_jit``): K6,
  ``glv_dev_verify`` on the w4 byte matrices, the split on the card;
- ``_sharded_glv`` (``_sharded_glv_jit``): K7, ``glv_verify`` from the
  host split (``pack_records_glv``);
- ``_sharded_w4`` (``_sharded_w4_jit``): K4, ``w4_verify_bytes``;
- ``_sharded_msm`` (``_sharded_msm_jit``): K9, ``msm_partial_point``'s
  launch on the shard's terms.

The host then folds what the reference's collectives gathered: the
verdict and degen planes concatenated in row order, the failure count
``(~ok | degen) & (q_inf == 0)`` summed over shards (the reference's
psum), and the MSM's Jacobian partials added by the Python-int oracle,
shards at infinity skipped. ``verify_batch_sharded`` keeps the
reference's rung choice and the host re-check of degenerate lanes; the
port's ``glv_dev_enabled()`` is always True (its rungs never latch), so
the host-split route is reached through ``_sharded_glv`` itself.

How shards reach the cards and come back (``_Staging``, kept per
program, lanes a shard and layout): the pack writes each shard's inputs
straight into one pinned host buffer, a shard's rows contiguous (its
arrays back to back); each shard is one copy of its rows into a device
buffer that is kept too, and the kernel takes views of it; every shard's
copy, launch and copies of its outputs into a pinned host buffer are
queued (mesh.run_shards) before any wait, and the folds read the pinned
outputs. Results come back to the host, so no card reads another's
memory. A layout of one card runs on its current stream, as the
unsharded call does.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..ops import ecdsa_batch as E
from ..ops import secp256k1 as S
from ..util import devicewatch as _dw
from .mesh import layout, note, run_shards

# per-shard lane granularity: the byte entries take multiples of 1024
# lanes
_CHIP_BUCKET = 1024

# Sharded-MSM program watch: per-shard buckets come off
# ops/ecdsa_batch._MSM_BUCKETS (6 rungs) and layouts sweep widths
# {1, 2, 4, 8}, so the signature space is 6 x 4.
_PW_SHARD_MSM = _dw.program("sig_shard_msm", shape_budget=24)

# The sharded programs: the per-shard wrapper's name in ops/secp256k1, the
# entry it counts its launches under, the bytes of a lane of each of its
# inputs in argument order (the pack's row widths: 32 or 16 a (lanes, w)
# matrix, 1 a (lanes,) plane), and the index of its q_inf plane
_PROGRAMS = {
    "glv_dev": ("ecdsa_verify_batch_glv_dev", "glv_dev_verify",
                E.W4_BYTES_ROW, 4),
    "glv": ("ecdsa_verify_batch_glv", "glv_verify", E.GLV_ROW, 9),
    "w4": ("ecdsa_verify_batch_pallas_w4_bytes", "w4_verify_bytes",
           E.W4_BYTES_ROW, 4),
    "msm": ("msm_partial_point", "msm_partial", E.MSM_ROW, 2),
}
_STAGING: dict = {}


def _views(buf, row: tuple, per: int) -> list:
    """A shard's flat byte buffer (numpy or torch) cut into its inputs:
    (per, w) for each row width w > 1, (per,) for w == 1, back to back."""
    out, o = [], 0
    for w in row:
        a = buf[o:o + per * w]
        out.append(a.reshape(per, w) if w > 1 else a)
        o += per * w
    return out


class _Staging:
    """The kept buffers of one sharded program at one (lanes a shard,
    layout), made once:
    - ``host``: a pinned host buffer (width, shard bytes) that the pack
      fills, each shard's arrays back to back (``inputs[c]``, numpy views);
    - on each shard's card, a buffer of a shard's bytes (``args[c]``: the
      kernel's inputs, views of it) and the kernel's outputs (``dev_out``:
      the (2, lanes) verdict and degen rows, or the MSM's 25 words and
      scratch);
    - ``plans[c]``: the shard's prepared launch on them
      (ops/secp256k1.verify_plan, msm_plan);
    - ``out``: a pinned host buffer of the shards' outputs.
    With it the GLV comb is uploaded to each card and that card's current
    stream synchronised, so the shards' streams read a finished comb. On a
    CPU layout the host buffer holds the inputs, nothing is pinned, and
    each shard runs its wrapper's plain version. ``lock``: one call at a
    time refills the buffers."""

    def __init__(self, name: str, per: int, devices: list):
        _wrapper, entry, row, _qinf = _PROGRAMS[name]
        width, nbytes = len(devices), per * sum(row)
        cuda = devices[0].type == "cuda"
        out_shape, out_dtype = ((S.MSM_WORDS,), torch.int32) \
            if name == "msm" else ((2, per), torch.uint8)
        self.lock = threading.Lock()
        self.host = torch.empty((width, nbytes), dtype=torch.uint8,
                                pin_memory=cuda)
        host = self.host.numpy()
        self.inputs = [_views(host[c], row, per) for c in range(width)]
        self.out = torch.empty((width, *out_shape), dtype=out_dtype,
                               pin_memory=cuda)
        if not cuda:
            self.args = [_views(b, row, per) for b in self.host]
            return
        if name in ("glv", "glv_dev"):
            for d in {str(d): d for d in devices}.values():
                S._comb_on(d, "words")
                torch.cuda.current_stream(d).synchronize()
        self.dev = [torch.empty(nbytes, dtype=torch.uint8, device=d)
                    for d in devices]
        self.args = [_views(b, row, per) for b in self.dev]
        self.dev_out = [torch.empty(out_shape, dtype=out_dtype, device=d)
                        for d in devices]
        if name == "msm":
            self.plans = [S.msm_plan(entry, args, [
                torch.empty(n, dtype=torch.int32, device=d)
                for n in S.msm_scratch_words(per).values()], out)
                for d, args, out in zip(devices, self.args, self.dev_out)]
        else:
            self.plans = [S.verify_plan(entry, args, out)
                          for args, out in zip(self.args, self.dev_out)]


def _staging(name: str, per: int, devices: list) -> _Staging:
    key = (name, per, tuple(devices))
    st = _STAGING.get(key)
    if st is None:
        st = _STAGING[key] = _Staging(name, per, devices)
    return st


def _copy_rows(arrays, per: int):
    """A staging fill from packed (B, ...) arrays: shard c's rows copied
    into its buffers."""
    def fill(c: int, dst: list) -> None:
        for d, a in zip(dst, arrays):
            np.copyto(d, np.asarray(a)[c * per:(c + 1) * per],
                      casting="unsafe")
    return fill


def _pack_rows(pack, items, per: int):
    """A staging fill that packs shard c's records (or terms) straight
    into its buffers."""
    return lambda c, dst: pack(items[c * per:(c + 1) * per], per, into=dst)


@contextlib.contextmanager
def _run_staged(name: str, fill, part: str, per: int, devices: list,
                plain):
    """One launch of program ``name`` a shard, as a context holding the
    staging's lock: fill every shard's staging (``fill(c, arrays)``; host
    seconds noted as ``part``), then mesh.run_shards: on CUDA each shard's
    rows to its card in one copy, its prepared launch, its outputs back in
    one copy into the pinned ``out`` (the shard's output None); on the CPU
    ``plain(st, c, args)`` (the shard's output). Yields (staging,
    outputs) for the fold to read."""
    st = _staging(name, per, devices)
    with st.lock:
        t0 = time.perf_counter()
        for c in range(len(devices)):
            fill(c, st.inputs[c])
        note(part, t0)
        shards = [(c,) for c in range(len(devices))]
        if devices[0].type == "cpu":
            yield st, run_shards(devices, lambda dev, c: plain(
                st, c, st.args[c]), shards)
            return

        def stage(dev, c):
            st.dev[c].copy_(st.host[c], non_blocking=True)
            return (c,)

        def launch(dev, c):
            st.plans[c](torch.cuda.current_stream(dev).cuda_stream)
            return c

        def collect(dev, c):
            st.out[c].copy_(st.dev_out[c], non_blocking=True)

        yield st, run_shards(devices, launch, shards, stage, collect)


def _plain_verify(wrapper: str):
    """A shard's plain verify on the CPU, its planes into ``out``."""
    def plain(st, c, args):
        ok, degen = getattr(S, wrapper)(*args)
        st.out[c, 0].copy_(ok)
        st.out[c, 1].copy_(degen)
    return plain


def _verify_shards(name: str, fill, part: str, per: int,
                   devices: list) -> tuple:
    """One launch of program ``name``'s per-shard entry a shard, on the
    rows ``fill(c, arrays)`` writes into shard c's staging; the folded
    (ok, degen, fails): planes in row order, fails summed over the
    shards."""
    wrapper, _entry, _row, qinf = _PROGRAMS[name]
    with _run_staged(name, fill, part, per, devices,
                     _plain_verify(wrapper)) as (st, _outs):
        t0 = time.perf_counter()
        planes = st.out.numpy().astype(bool)
        ok = planes[:, 0].reshape(-1)
        degen = planes[:, 1].reshape(-1)
        q_inf = np.concatenate([a[qinf] for a in st.inputs])
        # the reference's psum of each shard's failures among real lanes
        fails = int(np.sum((~ok | degen) & (q_inf == 0)))
        note("fold", t0)
    return ok, degen, fails


def _lanes(arrays, devices: list) -> int:
    return arrays[0].shape[0] // len(devices)


def _sharded_glv(d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8,
                 r0b, rnb, wrap8, devices: list) -> tuple:
    """The GLV verify from the host split (K7, ``glv_verify``) sharded on
    the batch axis, from packed arrays: one launch a shard; (ok, degen,
    fails)."""
    arrays = [d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b,
              rnb, wrap8]
    per = _lanes(arrays, devices)
    return _verify_shards("glv", _copy_rows(arrays, per), "stage", per,
                          devices)


def _sharded_glv_dev(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8,
                     devices: list) -> tuple:
    """The GLV verify with the split on the card (K6, ``glv_dev_verify``)
    sharded on the batch axis, from packed arrays: raw scalar bytes go to
    each shard, which splits its own lanes; (ok, degen, fails)."""
    arrays = [u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8]
    per = _lanes(arrays, devices)
    return _verify_shards("glv_dev", _copy_rows(arrays, per), "stage", per,
                          devices)


def _sharded_w4(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8,
                devices: list) -> tuple:
    """The w4 byte verify (K4, ``w4_verify_bytes``) sharded on the batch
    axis, from packed arrays; (ok, degen, fails). Degenerate lanes settle
    on the host and count as failures here, so the fast verdict stays
    conservative."""
    arrays = [u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8]
    per = _lanes(arrays, devices)
    return _verify_shards("w4", _copy_rows(arrays, per), "stage", per,
                          devices)


def _msm_shards(fill, part: str, per: int, devices: list) -> list:
    """One MSM launch (K9, ``msm_partial_point``'s) a shard, on the terms
    ``fill(c, arrays)`` writes into shard c's staging. Returns each
    shard's ((X, Y, Z), inf), canonical, in shard order."""
    with _run_staged("msm", fill, part, per, devices,
                     lambda st, c, args: S.msm_partial_point(*args)) \
            as (st, outs):
        t0 = time.perf_counter()
        parts = [S._words_result(st.out[c]) if o is None else o
                 for c, o in enumerate(outs)]
        note("copy_back", t0)
    return parts


def _sharded_msm(xm, ym, inf8, km, devices: list) -> list:
    """Sharded Pippenger MSM from packed arrays: the TERM axis shards
    across the layout (MSM is a sum, so it distributes over row shards);
    each shard runs the whole MSM kernel (K9, ``msm_partial_point``'s
    launch) over its terms. Returns each shard's ((X, Y, Z), inf),
    canonical, in shard order."""
    per = _lanes([xm], devices)
    return _msm_shards(_copy_rows([xm, ym, inf8, km], per), "stage", per,
                       devices)


def msm_is_infinity_sharded(terms, n_chips: int, devices=None) -> bool:
    """Batch-equation check over the layout: ``terms`` is the host-side
    [(x, y, scalar)] list from the Schnorr batch equation
    (ops/ecdsa_batch builds it); returns True iff Σ kᵢ·Pᵢ is the point
    at infinity. Pads the term count to an MSM bucket per shard so the
    launch shapes stay on the declared ladder; each shard's terms are
    packed straight into its staging. ``devices`` is the layout (default
    ``chip_mesh(n_chips)``)."""
    from ..crypto import secp256k1 as oracle
    from ..ops.ecdsa_batch import _msm_bucket_for, _msm_pack
    from ..util import devicewatch as dw

    devices = layout(n_chips, devices)
    per_chip = _msm_bucket_for(
        max(1, (len(terms) + n_chips - 1) // n_chips))
    bucket = per_chip * n_chips
    fill = _pack_rows(_msm_pack, terms, per_chip)
    dw.note_transfer("sig_shard", "h2d", bucket * sum(E.MSM_ROW))
    with _PW_SHARD_MSM.dispatch((bucket, n_chips)):
        out = _msm_shards(fill, "pack", per_chip, devices)
    # host fold: Jacobian partials -> affine -> oracle point_add chain
    t0 = time.perf_counter()
    acc = None
    for c in range(n_chips):
        (x, y, z), inf = out[c]
        if inf:
            continue  # chip saw only padded lanes
        if z == 0:
            continue
        zi = pow(z, -1, oracle.P)
        pt = ((x * zi * zi) % oracle.P,
              (y * zi * zi * zi) % oracle.P)
        acc = pt if acc is None else oracle.point_add(acc, pt)
    note("fold", t0)
    return acc is None


def verify_batch_sharded(records, n_chips: int,
                         kernel: str | None = None,
                         devices=None) -> np.ndarray:
    """Shard a record batch across the layout; returns (len(records),)
    bool. Pads B up to n_chips * 1024-lane shards with poisoned lanes
    (each shard's records packed straight into its staging); degenerate
    lanes (H == 0 collisions) re-verify on the host scalar path exactly
    like the single-device dispatch (ops/ecdsa_batch.BatchHandle).
    ``kernel`` overrides the -ecdsakernel selection for this call (None =
    active); ``devices`` is the layout (default ``chip_mesh(n_chips)``)."""
    from ..ops import ecdsa_batch
    from ..ops.ecdsa_batch import (
        _verify_cpu,
        pack_records_glv,
        pack_records_w4_bytes,
    )

    devices = layout(n_chips, devices)
    n = len(records)
    per_chip = max(
        _CHIP_BUCKET,
        ((n + n_chips - 1) // n_chips + _CHIP_BUCKET - 1)
        // _CHIP_BUCKET * _CHIP_BUCKET,
    )
    bucket = per_chip * n_chips
    from ..util import devicewatch as dw

    kern = kernel if kernel in ecdsa_batch.ECDSA_KERNELS \
        else ecdsa_batch.active_kernel()
    if (kern == "glv" and ecdsa_batch.glv_enabled()
            and ecdsa_batch.glv_dev_enabled()):
        # fused device-decompose program: the host pack is the w4 byte
        # emit, each chip splits its own scalar shard in-kernel
        fill = _pack_rows(pack_records_w4_bytes, records, per_chip)
        dw.note_transfer("sig_shard", "h2d",
                         bucket * sum(ecdsa_batch.W4_BYTES_ROW))
        # mesh-width x bucket is the compiled-shape signature; no budget —
        # virtual meshes legitimately sweep 1/2/4/8
        with dw.program("sig_shard_glv_dev").dispatch((bucket, n_chips)):
            ok, degen, _fails = _verify_shards("glv_dev", fill, "pack",
                                               per_chip, devices)
    elif kern == "glv" and ecdsa_batch.glv_enabled():
        fill = _pack_rows(pack_records_glv, records, per_chip)
        dw.note_transfer("sig_shard", "h2d",
                         bucket * sum(ecdsa_batch.GLV_ROW))
        with dw.program("sig_shard_glv").dispatch((bucket, n_chips)):
            ok, degen, _fails = _verify_shards("glv", fill, "pack",
                                               per_chip, devices)
    else:
        fill = _pack_rows(pack_records_w4_bytes, records, per_chip)
        dw.note_transfer("sig_shard", "h2d",
                         bucket * sum(ecdsa_batch.W4_BYTES_ROW))
        with dw.program("sig_shard_w4").dispatch((bucket, n_chips)):
            ok, degen, _fails = _verify_shards("w4", fill, "pack",
                                               per_chip, devices)
    out = np.asarray(ok)[:n].copy()
    degen = np.asarray(degen)[:n]
    t0 = time.perf_counter()
    idxs = np.nonzero(degen)[0]
    if idxs.size:
        from ..ops.ecdsa_batch import STATS

        STATS.degenerate_rechecks += int(idxs.size)
        out[idxs] = _verify_cpu([records[i] for i in idxs])
    note("recheck", t0)
    return out


def dryrun(n_devices: int) -> None:
    """A dry run of the sharded signature path: one sharded batch under
    the active kernel, one valid and one invalid signature among padded
    lanes, over ``n_devices`` shards."""
    import random

    from ..crypto import secp256k1 as oracle
    from ..script.interpreter import SigCheckRecord

    rng = random.Random(1)
    recs, expected = [], []
    for i in range(2):
        d = rng.randrange(1, oracle.N)
        pub = oracle.point_mul(d, oracle.G)
        e = rng.randrange(1 << 256)
        r, s = oracle.ecdsa_sign(d, e)
        if i == 1:
            e ^= 1  # corrupt: lane must report False
        recs.append(SigCheckRecord(pub, r, s, e))
        expected.append(oracle.ecdsa_verify(pub, r, s, e))
    from ..ops.ecdsa_batch import active_kernel

    got = verify_batch_sharded(recs, n_devices)
    assert got.tolist() == expected, (got.tolist(), expected)
    print(f"sig_shard dryrun: {n_devices}-chip sharded "
          f"{active_kernel()} sig batch OK")
