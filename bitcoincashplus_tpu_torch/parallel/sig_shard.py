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
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import secp256k1 as S
from ..util import devicewatch as _dw
from .mesh import layout, run_shards

# per-shard lane granularity: the byte entries take multiples of 1024
# lanes
_CHIP_BUCKET = 1024

# Sharded-MSM program watch: per-shard buckets come off
# ops/ecdsa_batch._MSM_BUCKETS (6 rungs) and layouts sweep widths
# {1, 2, 4, 8}, so the signature space is 6 x 4.
_PW_SHARD_MSM = _dw.program("sig_shard_msm", shape_budget=24)


def _rows(arrays, n_shards: int) -> list:
    """The shards' row blocks of each (B, ...) array, B a multiple of
    n_shards."""
    per = arrays[0].shape[0] // n_shards
    return [[a[c * per:(c + 1) * per] for a in arrays]
            for c in range(n_shards)]


def _on(dev, arrays) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _warm_comb(devices: list) -> None:
    """Upload the GLV comb to each card on its current stream before the
    shards' streams (which wait for it) read it."""
    for dev in {str(d): d for d in devices}.values():
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                S._comb_on(dev, "words")


def _verify_shards(verify, arrays, qinf8, devices: list) -> tuple:
    """One ``verify`` launch a shard on its rows; the folded (ok, degen,
    fails): planes in row order, fails summed over the shards."""
    def body(dev, *shard):
        return verify(*_on(dev, shard))

    outs = run_shards(devices, body, _rows(arrays, len(devices)))
    ok = np.concatenate([o.cpu().numpy() for o, _ in outs]).astype(bool)
    degen = np.concatenate([d.cpu().numpy() for _, d in outs]).astype(bool)
    # the reference's psum of each shard's failures among real lanes
    fails = int(np.sum((~ok | degen) & (np.asarray(qinf8) == 0)))
    return ok, degen, fails


def _sharded_glv(d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8,
                 r0b, rnb, wrap8, devices: list) -> tuple:
    """The GLV verify from the host split (K7, ``glv_verify``) sharded on
    the batch axis: one launch a shard; (ok, degen, fails)."""
    _warm_comb(devices)
    return _verify_shards(
        S.ecdsa_verify_batch_glv,
        [d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b, rnb,
         wrap8], qinf8, devices)


def _sharded_glv_dev(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8,
                     devices: list) -> tuple:
    """The GLV verify with the split on the card (K6, ``glv_dev_verify``)
    sharded on the batch axis: raw scalar bytes go to each shard, which
    splits its own lanes; (ok, degen, fails)."""
    _warm_comb(devices)
    return _verify_shards(
        S.ecdsa_verify_batch_glv_dev,
        [u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8], qinf8, devices)


def _sharded_w4(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8,
                devices: list) -> tuple:
    """The w4 byte verify (K4, ``w4_verify_bytes``) sharded on the batch
    axis; (ok, degen, fails). Degenerate lanes settle on the host and
    count as failures here, so the fast verdict stays conservative."""
    return _verify_shards(
        S.ecdsa_verify_batch_pallas_w4_bytes,
        [u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8], qinf8, devices)


def _sharded_msm(xm, ym, inf8, km, devices: list) -> list:
    """Sharded Pippenger MSM: the TERM axis shards across the layout (MSM
    is a sum, so it distributes over row shards); each shard runs the
    whole MSM kernel (K9, ``msm_partial_point``'s launch) over its terms.
    Returns each shard's ((X, Y, Z), inf), canonical, in shard order."""
    def body(dev, *shard):
        return S.msm_partial_launch(*_on(dev, shard))

    outs = run_shards(devices, body, _rows([xm, ym, inf8, km], len(devices)))
    return [S.msm_partial_result(o) for o in outs]


def msm_is_infinity_sharded(terms, n_chips: int, devices=None) -> bool:
    """Batch-equation check over the layout: ``terms`` is the host-side
    [(x, y, scalar)] list from the Schnorr batch equation
    (ops/ecdsa_batch builds it); returns True iff Σ kᵢ·Pᵢ is the point
    at infinity. Pads the term count to an MSM bucket per shard so the
    launch shapes stay on the declared ladder. ``devices`` is the layout
    (default ``chip_mesh(n_chips)``)."""
    from ..crypto import secp256k1 as oracle
    from ..ops.ecdsa_batch import _msm_bucket_for, _msm_pack
    from ..util import devicewatch as dw

    devices = layout(n_chips, devices)
    per_chip = _msm_bucket_for(
        max(1, (len(terms) + n_chips - 1) // n_chips))
    bucket = per_chip * n_chips
    arrays = [np.asarray(a) for a in _msm_pack(terms, bucket)]
    dw.note_transfer("sig_shard", "h2d",
                     sum(int(a.nbytes) for a in arrays))
    with _PW_SHARD_MSM.dispatch((bucket, n_chips)):
        out = _sharded_msm(*arrays, devices=devices)
    # host fold: Jacobian partials -> affine -> oracle point_add chain
    acc = None
    for c in range(n_chips):
        (x, y, z), inf = out[c]
        if inf:
            continue  # chip saw only padded lanes
        if z == 0:
            continue
        zi = pow(z, oracle.P - 2, oracle.P)
        pt = ((x * zi * zi) % oracle.P,
              (y * zi * zi * zi) % oracle.P)
        acc = pt if acc is None else oracle.point_add(acc, pt)
    return acc is None


def verify_batch_sharded(records, n_chips: int,
                         kernel: str | None = None,
                         devices=None) -> np.ndarray:
    """Shard a record batch across the layout; returns (len(records),)
    bool. Pads B up to n_chips * 1024-lane shards with poisoned lanes;
    degenerate lanes (H == 0 collisions) re-verify on the host scalar path
    exactly like the single-device dispatch (ops/ecdsa_batch.BatchHandle).
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
        arrays = [np.asarray(a)
                  for a in pack_records_w4_bytes(records, bucket)]
        dw.note_transfer("sig_shard", "h2d",
                         sum(int(a.nbytes) for a in arrays))
        # mesh-width x bucket is the compiled-shape signature; no budget —
        # virtual meshes legitimately sweep 1/2/4/8
        with dw.program("sig_shard_glv_dev").dispatch((bucket, n_chips)):
            ok, degen, _fails = _sharded_glv_dev(*arrays, devices=devices)
    elif kern == "glv" and ecdsa_batch.glv_enabled():
        arrays = [np.asarray(a) for a in pack_records_glv(records, bucket)]
        dw.note_transfer("sig_shard", "h2d",
                         sum(int(a.nbytes) for a in arrays))
        with dw.program("sig_shard_glv").dispatch((bucket, n_chips)):
            ok, degen, _fails = _sharded_glv(*arrays, devices=devices)
    else:
        arrays = [np.asarray(a)
                  for a in pack_records_w4_bytes(records, bucket)]
        dw.note_transfer("sig_shard", "h2d",
                         sum(int(a.nbytes) for a in arrays))
        with dw.program("sig_shard_w4").dispatch((bucket, n_chips)):
            ok, degen, _fails = _sharded_w4(*arrays, devices=devices)
    out = np.asarray(ok)[:n].copy()
    degen = np.asarray(degen)[:n]
    idxs = np.nonzero(degen)[0]
    if idxs.size:
        from ..ops.ecdsa_batch import STATS

        STATS.degenerate_rechecks += int(idxs.size)
        out[idxs] = _verify_cpu([records[i] for i in idxs])
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
