"""Differential tests of the port's bit ladder (K8: ladder_verify_plain and
its wrapper ecdsa_verify_batch_jit in ops/secp256k1.py of
bitcoincashplus_tpu_torch, the plain PyTorch version on the CPU) and of
the ``BCP_SECP_PALLAS=0`` route of its ops/ecdsa_batch.py, against the JAX
package: its oracle, its pack_records, and its point formulas
(pt_double, pt_add_mixed, pt_select) run eagerly for two ladder steps.

The JAX ladder itself (ecdsa_verify_batch_jit) compiles for minutes on
the CPU and is never compiled here; its steps run eagerly with
BCP_SECP_PARALLEL=1, the JAX package's switch to its scan-free field
forms. Field values are compared by their canonical value mod p, verdicts
exactly.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu.ops import ecdsa_batch as jeb
from bitcoincashplus_tpu.ops import secp256k1 as J
from bitcoincashplus_tpu.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as teb
from bitcoincashplus_tpu_torch.ops import secp256k1 as T

P, N, G = oracle.P, oracle.N, oracle.G
B = 32  # the plane buckets' smallest: every ladder run here is one


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's device switch on the CPU (the plain versions) and the
    process kernel restored afterwards."""
    before = cuda_build.device()
    cuda_build.set_device("cpu")
    monkeypatch.setattr(teb, "_KERNEL", None)
    yield
    cuda_build.set_device(before)


def sig_records(rng, n):
    """Valid signatures, every third invalid."""
    recs = []
    for i in range(n):
        d = rng.randrange(1, N)
        e = rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        if i % 3 == 2:
            e = (e + 1) % N
        recs.append(SigCheckRecord(oracle.point_mul(d, G), r, s, e))
    return recs


def signed(rng, d, e):
    r, s = oracle.ecdsa_sign(d, e)
    return SigCheckRecord(oracle.point_mul(d, G), r, s, e)


def tensors(arrays):
    """pack_records' numpy arrays as the CPU tensors the dispatch hands
    the wrapper (uint32 planes as int32 bit patterns)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        out.append(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                    else a))
    return out


@pytest.fixture(scope="module")
def corpus():
    """The crafted corpus of tests/test_torch_secp.py at bucket 32 (valid
    and invalid signatures, a Q = G lane with u1 == u2, wrap on and off,
    q_inf, padding), plus lanes where u1 = 0, Q = G, Q = -G, and Q = -G
    with u1 == u2 (the sum is infinity), run once through the wrapper.
    Returns (records, arrays, kinds, ok)."""
    rng = random.Random(81)
    recs = sig_records(rng, 20)
    # Q = G and e = r: u1 == u2, so the G and Q adds meet the
    # accumulator mid-ladder (P == Q); a valid signature
    k = rng.randrange(1, N)
    r = oracle.point_mul(k, G)[0] % N
    recs[1] = SigCheckRecord(G, r, pow(k, N - 2, N) * (2 * r) % N, r)
    kinds = {"u1_zero": 20, "q_g": 21, "q_minus_g": 22, "sum_inf": 23}
    recs.append(signed(rng, rng.randrange(1, N), 0))       # u1 = 0
    recs.append(signed(rng, 1, rng.randrange(N)))          # Q = G
    recs.append(signed(rng, N - 1, rng.randrange(N)))      # Q = -G
    # Q = -G and e = r: u1 G + u2 Q = 0 (P == -Q on the first add)
    r = rng.randrange(1, N)
    recs.append(SigCheckRecord(oracle.point_mul(N - 1, G), r,
                               rng.randrange(1, N), r))
    arrays = [a.copy() for a in teb.pack_records(recs, B)]
    u1, u2, qx, qy, qi, r0, rn, wr = arrays
    kinds.update(q_inf=[6], wrap_on=[7, 9], wrap_off=[10])
    qi[kinds["q_inf"]] = True
    for lanes, flag in ((kinds["wrap_on"], True), (kinds["wrap_off"], False)):
        # the true r as the wrap candidate, r0 wrong: only the gate decides
        rn[:, lanes] = r0[:, lanes]
        r0[:, lanes] ^= np.uint32(0x0F0)
        wr[lanes] = flag
    ok = T.ecdsa_verify_batch_jit(*tensors(arrays))
    return recs, arrays, kinds, ok


def test_plain_ladder_matches_the_oracle_on_the_crafted_corpus(corpus):
    recs, _arrays, kinds, ok = corpus
    want = np.zeros(B, bool)
    want[:len(recs)] = jeb._verify_cpu(recs)
    want[kinds["q_inf"]] = False
    want[kinds["wrap_off"]] = False
    assert ok.dtype == torch.bool and ok.shape == (B,)
    assert ok.tolist() == want.tolist()
    # the crafted lanes' verdicts, as the group law gives them
    for lane in (1, kinds["u1_zero"], kinds["q_g"], kinds["q_minus_g"]):
        assert ok[lane], lane
    assert not ok[kinds["sum_inf"]]
    assert not ok[len(recs):].any()  # padding lanes are poisoned


def _port_layout(arrays):
    """pack_records' planes -> ladder_verify_plain's layout (CPU)."""
    u1, u2, qx, qy, qi, r0, rn, wr = tensors(arrays)
    return (T._u32(u1).T != 0, T._u32(u2).T != 0, T._lim13(qx),
            T._lim13(qy), qi != 0, T._lim13(r0), T._lim13(rn), wr != 0)


def _window_meets_lanes():
    """Two lanes in ladder_verify_plain's layout where a later window's Q
    add meets the accumulator: u1 = 0x110, u2 = 0x10 and Q = 17 G (window
    62: 16 G + G = 17 G, then + 17 G, P == Q; the sum 544 G, its x as r0:
    valid) or Q = -17 G (P == -Q; the sum is infinity: invalid)."""
    q = oracle.point_mul(17, G)
    qs = [q, (q[0], P - q[1])]
    r0 = oracle.point_mul(544, G)[0]

    def bits(v):
        return [bool((v >> (255 - i)) & 1) for i in range(256)]

    return (torch.tensor([bits(0x110)] * 2), torch.tensor([bits(0x10)] * 2),
            T.to_limbs([p[0] for p in qs]), T.to_limbs([p[1] for p in qs]),
            torch.zeros(2, dtype=torch.bool), T.to_limbs([r0, r0]),
            T.to_limbs([0, 0]), torch.zeros(2, dtype=torch.bool))


def test_windowed_ladder_matches_the_bit_ladder_and_the_oracle(corpus):
    """The kernel's schedule (ladder_windowed_plain, behind the wrapper on
    the CPU) against the reference's bit ladder (ladder_verify_plain) and
    the oracle, lane for lane, on the crafted corpus and on two lanes
    where a later window's add meets the accumulator; the windowed
    ladder's complete adds meet P == Q and P == -Q there."""
    recs, arrays, kinds, ok = corpus
    port = _port_layout(arrays)
    crafted = _window_meets_lanes()
    both = [torch.cat([a, b]) for a, b in zip(port, crafted)]
    bit = T.ladder_verify_plain(*both)
    assert bit.tolist() == ok.tolist() + [True, False]
    tally = {}
    assert T.ladder_windowed_plain(*crafted, tally=tally).tolist() == \
        [True, False]
    assert tally["same"] >= 1 and tally["opposite"] >= 1
    tally = {}
    assert T.ladder_windowed_plain(*port, tally=tally).tolist() == \
        ok.tolist()
    assert tally["same"] >= 1 and tally["opposite"] >= 1  # lanes 1, 23
    want = np.zeros(B, bool)
    want[:len(recs)] = jeb._verify_cpu(recs)
    want[kinds["q_inf"] + kinds["wrap_off"]] = False
    assert ok.tolist() == want.tolist()


def test_wrap_ok_gate_blocks_bogus_wraparound(corpus):
    """The reference's case (tests/unit/test_ecdsa_batch.py:98):
    pack_records' wrap_ok is r + n < p and padding stays gated off; and
    the gate is the kernel's: a lane whose only match is X == rn Z^2
    verifies exactly where wrap_ok is set."""
    rng = random.Random(82)
    rec = signed(rng, rng.randrange(1, N), rng.randrange(1 << 256) % N)
    _u1, _u2, _qx, _qy, q_inf, _r0, _rn, wrap_ok = teb.pack_records([rec], 2)
    assert wrap_ok[0] == (rec.r + N < P)
    assert not wrap_ok[1] and q_inf[1]
    recs, _arrays, kinds, ok = corpus
    oracle_ok = jeb._verify_cpu(recs)
    for lane in kinds["wrap_on"]:
        assert ok[lane] == oracle_ok[lane]
    assert any(oracle_ok[lane] for lane in kinds["wrap_off"])
    assert not any(ok[lane] for lane in kinds["wrap_off"])


@pytest.mark.parametrize("bucket", [32, 128])
def test_pack_records_matches_the_reference(bucket):
    rng = random.Random(83 + bucket)
    recs = sig_records(rng, 10)
    mine = teb.pack_records(recs, bucket)
    ref = jeb.pack_records(recs, bucket)
    assert len(mine) == len(ref) == 8
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _jac(points_z):
    """(affine point or None, z) per lane -> Jacobian Python ints (X, Y,
    Z, inf); None is infinity (coordinates 1, 1, 0)."""
    out = []
    for pt, z in points_z:
        if pt is None:
            out.append((1, 1, 0, True))
        else:
            out.append((pt[0] * z * z % P, pt[1] * z * z * z % P, z, False))
    return out


def test_two_ladder_steps_match_the_jax_formulas(monkeypatch):
    """ladder_step against the JAX ladder's step (pt_double, then the
    complete pt_add_mixed of G and of Q, each behind pt_select on its bit,
    as in ecdsa_verify_batch_device) run eagerly at width 8, two steps.
    The first step meets every case of the complete add: P == Q at the G
    add (lane 1) and at the Q add (lane 3), P == -Q at the G add (lane 2),
    an infinite accumulator (lane 0) and a poisoned Q (lane 4)."""
    monkeypatch.setenv("BCP_SECP_PARALLEL", "1")
    rng = random.Random(84)
    W = 8
    qs = [oracle.point_mul(rng.randrange(1, N), G) for _ in range(W)]
    half = (N + 1) // 2  # 2 half == 1 mod n
    q3 = rng.randrange(1, N)
    qs[3] = oracle.point_mul(q3, G)
    starts = [None, oracle.point_mul(half, G),
              oracle.point_mul(half * (N - 1) % N, G),
              oracle.point_mul(half * q3 % N, G)] + [
        oracle.point_mul(rng.randrange(1, N), G) for _ in range(4)]
    acc0 = _jac([(pt, rng.randrange(1, P)) for pt in starts])
    bits1 = [(1, 1), (1, 0), (1, 1), (0, 1), (1, 1), (0, 0), (1, 0), (0, 1)]
    bits2 = [(rng.getrandbits(1), rng.getrandbits(1)) for _ in range(W)]
    q_inf = [i == 4 for i in range(W)]

    def jl(vals):
        return jnp.asarray(J.pack_batch_np([int(v) for v in vals]))

    jacc = {"X": jl([a[0] for a in acc0]), "Y": jl([a[1] for a in acc0]),
            "Z": jl([a[2] for a in acc0]),
            "inf": jnp.asarray([a[3] for a in acc0])}
    jqx, jqy = jl([q[0] for q in qs]), jl([q[1] for q in qs])
    jqi = jnp.asarray(q_inf)
    gx = jnp.broadcast_to(J._GX_CONST, (J.N_LIMBS, W)).astype(jnp.uint32)
    gy = jnp.broadcast_to(J._GY_CONST, (J.N_LIMBS, W)).astype(jnp.uint32)
    never_inf = jnp.zeros((W,), bool)

    tacc = tuple(T.to_limbs([a[k] for a in acc0]) for k in range(3)) + (
        torch.tensor([a[3] for a in acc0]),)
    tqx = T.to_limbs([q[0] for q in qs])
    tqy = T.to_limbs([q[1] for q in qs])
    tqi = torch.tensor(q_inf)

    for step, bits in enumerate((bits1, bits2)):
        b1 = [b[0] for b in bits]
        b2 = [b[1] for b in bits]
        # the body of ecdsa_verify_batch_device's step
        jacc = J.pt_double(jacc)
        with_g = J.pt_add_mixed(jacc, gx, gy, never_inf)
        jacc = J.pt_select(jnp.asarray(b1, bool), with_g, jacc)
        with_q = J.pt_add_mixed(jacc, jqx, jqy, jqi)
        jacc = J.pt_select(jnp.asarray(b2, bool) & ~jqi, with_q, jacc)
        tacc = T.ladder_step(tacc, torch.tensor(b1, dtype=torch.bool),
                             torch.tensor(b2, dtype=torch.bool), tqx, tqy,
                             tqi)
        inf = np.asarray(jacc["inf"]).tolist()
        assert tacc[3].tolist() == inf
        for key, t in zip("XYZ", tacc[:3]):
            a = np.asarray(jacc[key])
            jv = [J.from_limbs_np(a[:, k]) % P for k in range(W)]
            tv = [v % P for v in T.from_limbs(t)]
            assert [v for v, i in zip(tv, inf) if not i] == \
                [v for v, i in zip(jv, inf) if not i], key
        if step == 0:
            # the group's answer on the crafted lanes: G + Q, 2G, Q (G met
            # -G, then Q was added to infinity) and 2Q
            want = [oracle.point_add(G, qs[0]), oracle.point_double(G),
                    qs[2], oracle.point_double(qs[3])]
            X, Y, Z = (T.from_limbs(t) for t in tacc[:3])
            for lane, pt in enumerate(want):
                zi = pow(Z[lane] % P, P - 2, P)
                assert (X[lane] * zi * zi % P,
                        Y[lane] * zi * zi * zi % P) == pt, lane


def _dispatch_spies(monkeypatch, forbidden):
    """Count the wrapper calls of the ladder; the entries in
    ``forbidden`` fail the test if called."""
    calls = []
    real = T.ecdsa_verify_batch_jit

    def ladder(*arrays):
        calls.append(int(arrays[2].shape[1]))
        return real(*arrays)

    monkeypatch.setattr(T, "ecdsa_verify_batch_jit", ladder)
    for name in forbidden:
        def no(*_a, _name=name, **_k):
            raise AssertionError(f"{_name} ran under BCP_SECP_PALLAS=0")
        monkeypatch.setattr(T, name, no)
    return calls


W4_ENTRIES = ("ecdsa_verify_batch_pallas_w4_bytes",
              "ecdsa_verify_batch_pallas_w4")
GLV_ENTRIES = ("ecdsa_verify_batch_glv_dev", "ecdsa_verify_batch_glv")


@pytest.mark.parametrize("entry", ["dispatch_batch", "dispatch_packed"])
def test_pallas_off_w4_reaches_the_ladder(monkeypatch, on_cpu, entry):
    """BCP_SECP_PALLAS=0 under -ecdsakernel=w4: the record dispatch, and
    the packed dispatch through the record route, run the bit ladder at
    the reference's plane bucket (20 signatures + 2 known-answer lanes:
    32) and no w4 or GLV entry; the verdicts are the oracle's."""
    monkeypatch.setenv("BCP_SECP_PALLAS", "0")
    teb.set_kernel("w4")
    calls = _dispatch_spies(monkeypatch, W4_ENTRIES + GLV_ENTRIES)
    rng = random.Random(85)
    recs = sig_records(rng, 20)
    before = teb._PW_XLA.signatures.get((32,), 0)
    if entry == "dispatch_batch":
        ok = teb.dispatch_batch(recs, backend="device").result()
    else:
        ok = teb.dispatch_packed(*teb.records_to_blobs(recs),
                                 backend="device").result()
    assert calls == [jeb._bucket_for(len(recs) + 2, pallas=False)] == [32]
    assert teb._PW_XLA.signatures[(32,)] == before + 1
    assert ok.tolist() == jeb._verify_cpu(recs).tolist()


def test_pallas_off_glv_keeps_glv(monkeypatch, on_cpu):
    """BCP_SECP_PALLAS=0 under the default GLV: the record dispatch runs
    the GLV device split (no ladder), and the packed entry keeps its
    packed device leg (the reference's packed_ok: GLV needs no Pallas)."""
    monkeypatch.setenv("BCP_SECP_PALLAS", "0")
    calls = _dispatch_spies(monkeypatch, W4_ENTRIES)
    glv = []
    real = T.ecdsa_verify_batch_glv_dev

    def glv_dev(*arrays):
        glv.append(int(arrays[0].shape[0]))
        return real(*arrays)

    monkeypatch.setattr(T, "ecdsa_verify_batch_glv_dev", glv_dev)
    rng = random.Random(86)
    recs = sig_records(rng, 10)
    ok = teb.dispatch_batch(recs, backend="device").result()
    assert ok.tolist() == jeb._verify_cpu(recs).tolist()
    assert glv == [1024] and calls == []
    packed = []
    monkeypatch.setattr(teb, "_dispatch_packed_device",
                        lambda *a: packed.append(a[5]) or teb.BatchHandle(
                            a[5], cpu_ok=np.ones(a[5], bool)))
    teb.dispatch_packed(*teb.records_to_blobs(recs), backend="device")
    assert packed == [len(recs)] and calls == []


@pytest.mark.parametrize("value,enabled", [(None, True), ("1", True),
                                           ("0", False), ("false", False)])
def test_pallas_enabled_reads_the_setting_at_each_call(monkeypatch, value,
                                                       enabled):
    if value is None:
        monkeypatch.delenv("BCP_SECP_PALLAS", raising=False)
    else:
        monkeypatch.setenv("BCP_SECP_PALLAS", value)
    assert teb.pallas_enabled() is enabled


def test_no_card_raises_kernel_unavailable(monkeypatch):
    """The device switch on cuda with no card: the ladder route raises
    KernelUnavailable, and the wrapper raises for tensors on a device that
    is neither the CPU nor CUDA; neither falls back to the plain
    version."""
    monkeypatch.setenv("BCP_SECP_PALLAS", "0")
    monkeypatch.setattr(teb, "_KERNEL", "w4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = cuda_build.device()
    cuda_build.set_device("cuda")
    try:
        recs = sig_records(random.Random(87), 9)
        with pytest.raises(cuda_build.KernelUnavailable):
            teb.dispatch_batch(recs, backend="device")
    finally:
        cuda_build.set_device(before)
    meta = [torch.empty((256, B), dtype=torch.int32, device="meta")] * 2 + [
        torch.empty((20, B), dtype=torch.int32, device="meta")] * 2 + [
        torch.empty(B, dtype=torch.bool, device="meta")] + [
        torch.empty((20, B), dtype=torch.int32, device="meta")] * 2 + [
        torch.empty(B, dtype=torch.bool, device="meta")]
    with pytest.raises(cuda_build.KernelUnavailable):
        T.ecdsa_verify_batch_jit(*meta)


def test_kernel_g_matches_the_oracle():
    """csrc/ladder_verify.cu carries G's table (jG, j = 1 .. 15, affine) as
    literals: hold them against the oracle."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(T.__file__), "..", "csrc",
                            "ladder_verify.cu")).read()
    body = src[src.index("c_gtab[15][2][8] = {"):]
    body = body[:body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert len(words) == 15 * 16
    coords = [sum(w << (32 * i) for i, w in enumerate(words[8 * c:8 * c + 8]))
              for c in range(30)]
    want, pt = [], G
    for _j in range(15):
        want += list(pt)
        pt = oracle.point_add(pt, G)
    assert coords == want
