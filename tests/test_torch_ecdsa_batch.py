"""The port's ECDSA dispatch layer (bitcoincashplus_tpu_torch/ops/
ecdsa_batch.py) on the CPU device — the plain PyTorch w4 verify stands in
for the CUDA kernel — against the JAX package's verify_batch(backend=
"cpu"): dispatch_batch (plane entry), dispatch_packed (byte entry),
LanePacker, the known-answer lanes, the degen re-check, the supervision
that must not degrade a missing kernel, and the device selection rules.
Each test runs the w4 rung (-ecdsakernel=w4); the GLV rungs, the default,
are tests/test_torch_glv.py."""

import random

import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu.ops import ecdsa_batch as jeb
from bitcoincashplus_tpu.script.interpreter import SigCheckRecord as JRecord
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import dispatch as tdispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as S
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.util import faults

N = oracle.N


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain verify's tensors are small, and the
    suite runs in several worker processes at once — a thread pool per
    worker only oversubscribes the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_records(seed, n, bad_every=4, degenerate=()):
    """Port records and the same signatures as JAX-package records."""
    rng = random.Random(seed)
    ours, theirs = [], []
    for i in range(n):
        if i in degenerate:  # pubkey G, e = r: u1 == u2 (H == 0 collision)
            k = rng.randrange(1, N)
            r = oracle.point_mul(k, oracle.G)[0] % N
            pub, s, e = oracle.G, pow(k, N - 2, N) * (2 * r) % N, r
        else:
            d = rng.randrange(1, N)
            pub = oracle.point_mul(d, oracle.G)
            e = rng.randrange(N)
            r, s = oracle.ecdsa_sign(d, e)
            if i % bad_every == 1:
                e = (e + 1) % N
        ours.append(SigCheckRecord(pub, r, s, e))
        theirs.append(JRecord(pub, r, s, e))
    return ours, theirs


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS", "BCP_ECDSA_KERNEL",
              "BCP_NO_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    faults.INJECTOR.reload()
    tdispatch.reset()
    E.STATS.__init__()
    monkeypatch.setattr(E, "_KERNEL", "w4")
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    E.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    tdispatch.reset()


def test_dispatch_batch_matches_jax_cpu_verdicts_with_degen_recheck():
    ours, theirs = make_records(1, 20, degenerate=(3, 11))
    expect = jeb.verify_batch(theirs, backend="cpu")
    handle = E.dispatch_batch(ours, backend="device")
    assert handle._bucket == 32  # 20 records + 2 known-answer lanes
    got = handle.result()
    assert got.tolist() == expect.tolist()
    assert expect[3] and expect[11]
    st = E.STATS
    assert st.dispatches == 1 and st.sigs_padded == 12
    assert st.degenerate_rechecks == 2
    assert st.reject_confirm_sigs == int((~expect).sum())
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    assert E.STATS.buckets_used == {32: 1}
    assert E._PW_W4.signatures.get((32,), 0) >= 1  # devicewatch saw it


def test_devicewatch_shape_budget_sentinel():
    from bitcoincashplus_tpu_torch.util import devicewatch as dw

    pw = dw.ProgramWatch("test_budget", shape_budget=1)
    for sig in (1024, 1024, 2048):
        with pw.dispatch(sig):
            pass
    snap = pw.snapshot()
    assert snap["dispatches"] == 3 and snap["shapes"] == 2
    assert snap["new_shapes"] == 2 and snap["retraces_unexpected"] == 1
    with dw.phase("ecdsa", "pack"):
        dw.note_transfer("test_site", "h2d", 256)
    assert dw.transfer_snapshot()["test_site"]["h2d"] >= 256


def test_known_answer_lanes_catch_a_lying_device(monkeypatch):
    ours, theirs = make_records(2, 10)
    monkeypatch.setenv("BCP_FAULT_MODE", "poison-output")
    monkeypatch.setenv("BCP_FAULT_OPS", "ecdsa")
    faults.INJECTOR.reload()
    got = E.verify_batch(ours, backend="device")
    # the inverted mask fails the KAT gate: the verdict is a fresh CPU
    # re-verification, never the poisoned output
    assert got.tolist() == jeb.verify_batch(theirs, backend="cpu").tolist()
    assert E.STATS.kat_failures == 1
    assert E.STATS.fault_fallback_sigs == 10


def test_dispatch_packed_uses_byte_entry_and_matches_native():
    from bitcoincashplus_tpu_torch import native

    ours, theirs = make_records(3, 24)
    pub, rs, msg, rn, wrap = E.records_to_blobs(ours)
    before = dict(S.LAUNCHES)
    handle = E.dispatch_packed(pub, rs, msg, rn, wrap, backend="device")
    assert handle._bucket == 1024
    got = handle.result()
    # on the CPU device the byte wrapper took the plain version: no launch
    assert S.LAUNCHES == before
    assert got.tolist() == jeb.verify_batch(theirs, backend="cpu").tolist()
    if native.available():
        cpu = native.ecdsa_verify_batch_blobs(pub.tobytes(), rs.tobytes(),
                                              msg.tobytes(), len(msg))
        assert got.tolist() == list(map(bool, cpu))
    assert E.STATS.cpu_fallback_sigs == 0


def test_lane_packer_futures_match_per_block_verdicts():
    ours, theirs = make_records(4, 26)
    packer = E.LanePacker(backend="device", lanes=24, kernel="w4")
    blocks = [(0, 9), (9, 20), (20, 26)]
    futs = [packer.add(ours[a:b]) for a, b in blocks]
    assert packer.stats["dispatches"] == 1  # 24 of 26 lanes banked
    results = [f.result() for f in futs]
    expect = jeb.verify_batch(theirs, backend="cpu")
    for (a, b), res in zip(blocks, results):
        assert res.tolist() == expect[a:b].tolist()
    snap = packer.snapshot()
    assert snap["lanes_real"] == 26 and snap["pending_lanes"] == 0
    assert snap["dispatches"] == 2 and E.STATS.cpu_fallback_sigs == 0


def test_only_w4_exists_and_later_kernels_raise(monkeypatch):
    # the reference's three kernels exist — GLV (the default), w4 and the
    # Schnorr MSM — and any other name raises, leaving the selection as
    # it was
    monkeypatch.setattr(E, "_KERNEL", None)
    assert E.ECDSA_KERNELS == ("glv", "w4", "msm")
    assert E.active_kernel() == "glv"
    with pytest.raises(ValueError, match="unknown"):
        E.set_kernel("xla")
    assert E.active_kernel() == "glv"  # rejected = unchanged
    assert E.set_kernel("msm") == "msm"
    assert E.active_kernel() == "msm"
    assert E.set_kernel("w4") == "w4"
    assert E.active_kernel() == "w4"
    with pytest.raises(ValueError, match="unknown"):
        E.dispatch_batch(make_records(5, 9)[0], backend="device",
                         kernel="xla")


def test_cuda_without_a_card_raises_and_is_never_degraded():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    ours, _ = make_records(6, 9)
    E.set_device("cuda")
    # CUDA selected: the device is the one to dispatch to, card or not
    assert E._device_available()
    with pytest.raises(S.KernelUnavailable):
        E.dispatch_batch(ours, backend="device")
    pub, rs, msg, rn, wrap = E.records_to_blobs(ours)
    with pytest.raises(S.KernelUnavailable):
        E.dispatch_packed(pub, rs, msg, rn, wrap, backend="device")
    assert E.STATS.fault_fallback_sigs == 0
    assert E.STATS.cpu_fallback_sigs == 0
    # "auto" keeps a batch under CPU_FLOOR on the CPU engine by design
    few = ours[:E.CPU_FLOOR - 1]
    assert E.verify_batch(few, backend="auto").tolist() == [
        oracle.ecdsa_verify(r.pubkey, r.r, r.s, r.msg_hash) for r in few]
    assert E.STATS.cpu_fallback_sigs == len(few)
    # from CPU_FLOOR on, "auto" takes the device leg, which raises
    for n in (E.CPU_FLOOR, len(ours)):
        with pytest.raises(S.KernelUnavailable):
            E.verify_batch(ours[:n], backend="auto")
    assert E.STATS.fault_fallback_sigs == 0
    assert E.STATS.cpu_fallback_sigs == len(few)


def test_kernel_unavailable_is_not_a_dispatch_failure(monkeypatch):
    def broken(*_a):
        raise S.KernelUnavailable("nvcc failed")

    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4", broken)
    ours, _ = make_records(7, 9)
    with pytest.raises(S.KernelUnavailable):
        E.dispatch_batch(ours, backend="device")
    packer = E.LanePacker(backend="device", lanes=4)
    with pytest.raises(S.KernelUnavailable):
        packer.add(ours)
    br = tdispatch.breaker("ecdsa")
    assert br.healthy() and br.snapshot()["fallback_calls"] == 0
    assert E.STATS.fault_fallback_sigs == 0


def test_cuda_runtime_error_surfaces_as_kernel_unavailable(monkeypatch):
    """A CUDA error that torch reports (an illegal address in the kernel,
    a failed launch) is a broken kernel, not a transient fault: it raises
    KernelUnavailable at the verdict read and at enqueue, and nothing is
    re-verified on the CPU in its place."""
    def cuda_error(*_a):
        raise RuntimeError(
            "CUDA error: an illegal memory access was encountered")

    def enqueued(*a):  # a launch that returned; the fault shows at the read
        none = torch.zeros(a[2].shape[1], dtype=torch.bool)
        return none, none.clone()

    ours, _ = make_records(9, 9)
    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4", enqueued)
    handle = E.dispatch_batch(ours, backend="device")
    monkeypatch.setattr(E, "_host", cuda_error)
    with pytest.raises(S.KernelUnavailable, match="illegal memory"):
        handle.result()
    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4", cuda_error)
    with pytest.raises(S.KernelUnavailable, match="illegal memory"):
        E.dispatch_batch(ours, backend="device")
    pub, rs, msg, rn, wrap = E.records_to_blobs(ours)
    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4_bytes", cuda_error)
    with pytest.raises(S.KernelUnavailable, match="illegal memory"):
        E.dispatch_packed(pub, rs, msg, rn, wrap, backend="device")
    assert E.STATS.fault_fallback_sigs == 0
    assert E.STATS.cpu_fallback_sigs == 0
    assert tdispatch.breaker("ecdsa").snapshot()["fallback_calls"] == 0


def test_transient_device_faults_keep_the_supervision(monkeypatch):
    ours, theirs = make_records(8, 9)
    monkeypatch.setenv("BCP_FAULT_MODE", "fail-always")
    monkeypatch.setenv("BCP_FAULT_OPS", "ecdsa")
    faults.INJECTOR.reload()
    got = E.verify_batch(ours, backend="device")
    assert got.tolist() == jeb.verify_batch(theirs, backend="cpu").tolist()
    assert E.STATS.fault_fallback_sigs == 9
    assert tdispatch.breaker("ecdsa").snapshot()["consecutive_failures"] == 1


def test_bucket_ladder_and_packing_match_the_reference():
    for n in (1, 32, 33, 128, 129, 1024, 1025, 2048, 4097, 8192, 16384,
              16385):
        assert E._bucket_for(n, pallas=True) == jeb._bucket_for(n, True)
        assert E._bucket_for(n) == jeb._bucket_for(n)
    ours, theirs = make_records(9, 5)
    for a, b in zip(E.pack_records_w4_bytes(ours, 1024),
                    jeb.pack_records_w4_bytes(theirs, 1024)):
        assert np.array_equal(a, b)
    for a, b in zip(E.pack_records_w4(ours, 32),
                    jeb.pack_records_w4(theirs, 32)):
        assert np.array_equal(a, b)
