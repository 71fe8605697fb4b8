"""The port's GLV rungs on the CPU device — the plain PyTorch versions of
ops/secp256k1.py stand in for csrc/glv_verify.cu — against the JAX
package's GLV functions and the Python-int oracle: the constants (and the
kernel's copies of them), the numpy split and sign fold, the exact limb
split, the comb, the table build, window step and comb step (crafted H == 0
collisions included), whole verifies on an edge corpus, and the ladder of
ops/ecdsa_batch.py (GLV the default; injected faults step down one rung;
any other failure raises KernelUnavailable).

The JAX pieces run eagerly with BCP_SECP_PARALLEL=1 (the JAX package's
switch to its scan-free field forms); no JAX GLV program is compiled
(_glv_dev_program, _glv_program and _glv_decompose_program cost minutes
of XLA compile on the CPU). Everything is integer arithmetic: every
comparison is exact.
"""

import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu.ops import secp256k1 as J
from bitcoincashplus_tpu_torch import native
from bitcoincashplus_tpu_torch.consensus.block import CBlock
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import dispatch as tdispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as T
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.util import faults
from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
from bitcoincashplus_tpu_torch.workload import sigchain

P, N = oracle.P, oracle.N


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain verify's tensors are small, and the
    suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS", "BCP_ECDSA_KERNEL",
              "BCP_NO_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    faults.INJECTOR.reload()
    tdispatch.reset()
    E.STATS.__init__()
    monkeypatch.setattr(E, "_KERNEL", None)
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    E.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    tdispatch.reset()


@pytest.fixture
def jax_parallel_fields(monkeypatch):
    monkeypatch.setenv("BCP_SECP_PARALLEL", "1")


def arm(monkeypatch, mode: str, site: str) -> None:
    monkeypatch.setenv("BCP_FAULT_MODE", mode)
    monkeypatch.setenv("BCP_FAULT_OPS", site)
    faults.INJECTOR.reload()


# ---- helpers ----------------------------------------------------------------

def scalar_bytes(vals) -> np.ndarray:
    return np.frombuffer(b"".join(int(v).to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(len(vals), 32).copy()


def edge_scalars() -> list:
    """The split's edges (those of tests/unit/test_glv.py): lambda
    boundaries, k2 = 0, every sign quadrant, all-ones limbs, 2^256 - 1."""
    L = T.LAMBDA
    return [0, 1, 2, 5, 7, N - 1, N - 2, L - 1, L, L + 1, N - L, N // 2,
            1 << 127, 1 << 128, (1 << 128) - 1, 1 << 255, (1 << 255) % N,
            int("1fff" * 16, 16) % N, int("ffff" * 16, 16),
            ((1 << 256) - 1) % N]


def jax_limbs(vals):
    return jnp.asarray(J.pack_batch_np([int(v) % P for v in vals]))


def jax_vals(arr) -> list:
    a = np.asarray(arr)
    return [J.from_limbs_np(a[:, k]) % P for k in range(a.shape[1])]


def port_vals(t) -> list:
    return [v % P for v in T.from_limbs(t)]


def port_limbs(vals):
    return T.to_limbs([int(v) % P for v in vals])


def limbs_int(row, bits: int) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(row))


def records_with_scalars(triples) -> list:
    """Valid signatures with chosen verify scalars (u1, u2, q): R = u1 G +
    u2 Q with Q = q G, r = R.x mod n, s = r / u2, e = u1 s."""
    out = []
    for u1, u2, q in triples:
        Q = oracle.point_mul(q, oracle.G)
        R = oracle.point_add(oracle.point_mul(u1, oracle.G),
                             oracle.point_mul(u2, Q))
        if R is None or R[0] % N == 0 or u2 % N == 0:
            continue
        r = R[0] % N
        s = r * pow(u2, N - 2, N) % N
        out.append(SigCheckRecord(Q, r, s, u1 * s % N))
    return out


def edge_corpus(seed: int = 1905) -> list:
    """tests/unit/test_glv.py's adversarial corpus, built with the port's
    records: lambda-boundary and k2 = 0 splits of u1 and u2, u1 = 0 (the
    comb idle), tiny u2, corrupt twins, a bogus wrap claim (r = 5), and a
    GLV-degenerate lane (Q = G, u1 = u2 = 5: the ladder leaves 5G, the
    comb's first digit adds 5G)."""
    rng = random.Random(seed)
    L = T.LAMBDA
    specials = [0, 1, 7, (1 << 128) - 1, L - 1, L, L + 1, N - L, N - 1,
                N // 2, 1 << 127]
    triples = [(rng.randrange(N), u2, rng.randrange(1, N))
               for u2 in specials if u2 % N]
    triples += [(u1, rng.randrange(1, N), rng.randrange(1, N))
                for u1 in specials]
    triples.append((5, 5, 1))
    recs = records_with_scalars(triples)
    bad = [SigCheckRecord(r.pubkey, r.r, r.s, (r.msg_hash + 1) % N)
           for r in recs[::3]]
    bad.append(SigCheckRecord(recs[0].pubkey, 5, recs[0].s, recs[0].msg_hash))
    return recs + bad


def oracle_verdicts(recs) -> list:
    return [oracle.ecdsa_verify(r.pubkey, r.r, r.s, r.msg_hash) for r in recs]


def make_records(seed: int, n: int) -> list:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        d = rng.randrange(1, N)
        e = rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        out.append(SigCheckRecord(oracle.point_mul(d, oracle.G), r, s,
                                  (e + 1) % N if i % 4 == 1 else e))
    return out


def tensors(arrays) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- constants, numpy helpers, the split, the comb -------------------------

def test_constants_match_the_reference_and_the_kernel():
    for name in ("LAMBDA", "BETA", "_GLV_A1", "_GLV_MINUS_B1", "_GLV_A2",
                 "_GLV_B2", "_GLV_G1_INT", "_GLV_G2_INT", "GLV_WINDOWS",
                 "GLV_COMB_TEETH"):
        assert getattr(T, name) == getattr(J, name), name
    src = "".join(open(os.path.join(cuda_build.CSRC_DIR, f)).read()
                  for f in ("glv_split.cuh", "glv_lane.cuh", "glv_verify.cu",
                            "glv_pair.cu"))
    want = {"c_beta": T.BETA, "c_n": N, "c_half_n": (N + 1) // 2,
            "c_g1": T._GLV_G1_INT, "c_g2": T._GLV_G2_INT, "c_b2": T._GLV_B2,
            "c_minus_b1": T._GLV_MINUS_B1, "c_a1": T._GLV_A1,
            "c_a2": T._GLV_A2}
    for name, value in want.items():
        m = re.search(r"__constant__ u32 %s\[(\d+)\] = \{([^}]*)\}" % name,
                      src)
        words = [int(w.strip().rstrip("u"), 16)
                 for w in m.group(2).split(",")]
        assert len(words) == int(m.group(1)), name
        assert limbs_int(words, 32) == value, name
    for entry in ("glv_dev_verify", "glv_verify", "glv_decompose",
                  "glv_dev_verify_pair", "glv_verify_pair"):
        assert f'extern "C" int {entry}(' in src


def test_numpy_split_and_fold_match_the_reference():
    rng = random.Random(21)
    ks = edge_scalars() + [rng.randrange(N) for _ in range(512)]
    km = scalar_bytes(ks)
    for a, b in zip(T.glv_split_batch_np(km), J.glv_split_batch_np(km)):
        assert np.array_equal(a, b)
    m1, n1, m2, n2 = T.glv_decompose_batch_np(km)
    for a, b in zip((m1, n1, m2, n2), J.glv_decompose_batch_np(km)):
        assert np.array_equal(a, b)
    for i, k in enumerate(ks):
        assert (int.from_bytes(m1[i].tobytes(), "little"), int(n1[i]),
                int.from_bytes(m2[i].tobytes(), "little"), int(n2[i])) \
            == T.glv_decompose(k) == J.glv_decompose(k), hex(k)
    ys = scalar_bytes([rng.randrange(1, P) for _ in range(64)] + [1, P - 1])
    assert np.array_equal(T.field_neg_bytes_np(ys), J.field_neg_bytes_np(ys))


def test_split_plain_matches_the_oracle_and_the_jax_device_split(
        jax_parallel_fields):
    rng = random.Random(22)
    ks = edge_scalars() + [rng.randrange(N) for _ in range(64)]
    km = scalar_bytes(ks)
    m1, n1, m2, n2 = T.glv_split_plain(torch.from_numpy(km))
    jm1, jn1, jm2, jn2 = (np.asarray(a) for a in J._glv_split_device(
        J._expand_limb_cols(jnp.asarray(km))))
    quadrants = set()
    for i, k in enumerate(ks):
        want = J.glv_decompose(k)
        assert (limbs_int(m1[i].tolist(), 16), int(n1[i]),
                limbs_int(m2[i].tolist(), 16), int(n2[i])) == want, hex(k)
        assert (limbs_int(jm1[:, i], 13), int(jn1[i]),
                limbs_int(jm2[:, i], 13), int(jn2[i])) == want, hex(k)
        quadrants.add((want[1], want[3]))
    assert quadrants == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # the decompose wrapper on a CPU tensor: the plain version, byte for
    # byte the reference's numpy split
    out = T.glv_decompose_device_batch(torch.from_numpy(km))
    for a, b in zip(out, J.glv_decompose_batch_np(km)):
        assert np.array_equal(a.numpy(), b)


def test_comb_matches_the_reference():
    comb = T._glv_comb()
    assert comb.shape == (3, T.GLV_COMB_TEETH, 512, 8)
    assert np.array_equal(T.comb_from_jax(*J._glv_comb()), comb)
    assert T.GLV_TABLE_BUILD_S > 0

    def val(c, i, e):
        return limbs_int(comb[c, i, e].tolist(), 32)

    for i, d in ((0, 1), (3, 77), (15, 255)):
        x, y = oracle.point_mul(d * 256 ** i, oracle.G)
        assert val(0, i, d) == val(0, i, 256 + d) == x
        assert val(1, i, d) == y and val(1, i, 256 + d) == P - y
        assert val(2, i, d) == val(2, i, 256 + d) == x * T.BETA % P
    # the d = 0 dummies hold the d = 1 point
    assert val(0, 4, 0) == val(0, 4, 1) and val(1, 4, 256) == val(1, 4, 257)
    # the plain form: the same values as 16-bit limbs
    limbs = T._comb_on("cpu", "limbs")
    assert limbs.shape == (3, T.GLV_COMB_TEETH, 512, 16)
    assert T.from_limbs(limbs[1, 3, 300:301]) == [val(1, 3, 300)]


# ---- the core pieces against the JAX ones (six lanes, eager JAX) -----------

def _jax_one(B: int):
    return jnp.asarray(np.broadcast_to(
        J.to_limbs_np(1).reshape(J.N_LIMBS, 1),
        (J.N_LIMBS, B))).astype(jnp.uint32)


def _jac(pt, z):
    return (pt[0] * z * z % P, pt[1] * z * z * z % P, z)


def _accs(scalars, rng):
    return [_jac(oracle.point_mul(a, oracle.G), rng.randrange(1, P))
            for a in scalars]


def _both_accs(accs, acc_inf):
    B = len(accs)
    jacc = {"X": jax_limbs([a[0] for a in accs]),
            "Y": jax_limbs([a[1] for a in accs]),
            "Z": jax_limbs([a[2] for a in accs]),
            "inf": jnp.asarray(np.array(acc_inf, np.int32).reshape(1, B))}
    tacc = tuple(port_limbs([a[k] for a in accs]) for k in range(3)) + (
        torch.tensor(acc_inf),)
    return jacc, tacc


def _assert_same(tout, tdeg, jout, jdeg, expect_degen):
    B = len(expect_degen)
    deg = np.asarray(jdeg).reshape(B).astype(bool)
    assert tdeg.tolist() == deg.tolist() == expect_degen
    finite = ~np.asarray(jout["inf"]).reshape(B).astype(bool)
    assert tout[3].tolist() == (~finite).tolist()
    for k, c in enumerate("XYZ"):
        tv, jv = port_vals(tout[k]), jax_vals(jout[c])
        assert [tv[i] for i in range(B) if finite[i] and not deg[i]] == \
            [jv[i] for i in range(B) if finite[i] and not deg[i]], c


@pytest.fixture(scope="module")
def glv_tables():
    """Q and lambda Q tables of six lanes by both packages: lanes 0 and 1
    have Q = G (the window-step test crafts collisions there), lane 4 is
    q_inf; ydiff on lanes 1, 3 and 5."""
    rng = random.Random(23)
    B = 6
    qs = [oracle.G, oracle.G] + [
        oracle.point_mul(rng.randrange(1, N), oracle.G) for _ in range(4)]
    q_inf = [i == 4 for i in range(B)]
    ydiff = [i % 2 == 1 for i in range(B)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCP_SECP_PARALLEL", "1")
        jqi = jnp.asarray(np.array(q_inf, np.int32).reshape(1, B))
        jt1, jt2 = J._glv_q_tables(
            jax_limbs([q[0] for q in qs]), jax_limbs([q[1] for q in qs]),
            jnp.asarray(np.array(ydiff, np.int32).reshape(1, B)), jqi,
            _jax_one(B))
    tqi = torch.tensor(q_inf)
    tt1, tt2 = T._glv_q_tables(port_limbs([q[0] for q in qs]),
                               port_limbs([q[1] for q in qs]),
                               torch.tensor(ydiff), tqi)
    return {"B": B, "qs": qs, "q_inf": q_inf, "ydiff": ydiff, "jqi": jqi,
            "tqi": tqi, "jax": (jt1, jt2), "port": (tt1, tt2)}


def test_q_tables_match_jax(glv_tables):
    g = glv_tables
    live = [i for i in range(g["B"]) if not g["q_inf"][i]]
    for t in range(2):
        for j in range(16):
            for k in range(3):
                tv = port_vals(g["port"][t][k][j])
                jv = jax_vals(g["jax"][t][k][j])
                assert [tv[i] for i in live] == [jv[i] for i in live], \
                    (t, j, k)
    # and they are j Q and j (-+lambda Q) (entry 0: the dummy 1 Q)
    for lane in live:
        for j in (0, 1, 2, 9, 15):
            for t, mult in ((0, 1), (1, T.LAMBDA)):
                x, y, z = (port_vals(g["port"][t][k][j])[lane]
                           for k in range(3))
                zi = pow(z, P - 2, P)
                sign = -1 if t and g["ydiff"][lane] else 1
                want = oracle.point_mul(sign * max(j, 1) * mult % N,
                                        g["qs"][lane])
                assert (x * zi * zi % P, y * zi * zi * zi % P) == want


def test_window_step_matches_jax_including_collisions(glv_tables,
                                                      jax_parallel_fields):
    """One ladder window on random accumulators, plus crafted lanes where
    the Q-stream add (lane 0) and the lambda Q-stream add (lane 1, ydiff
    set) collide with H == 0."""
    g = glv_tables
    B = g["B"]
    rng = random.Random(24)
    w1 = [5, 2, 0, 7, 15, 9]
    w2 = [3, 9, 4, 0, 11, 6]
    inv16 = pow(16, N - 2, N)
    scalars = [w1[0] * inv16 % N,
               (-w2[1] * T.LAMBDA - w1[1]) * inv16 % N] + [
        rng.randrange(1, N) for _ in range(4)]
    acc_inf = [False] * (B - 1) + [True]
    jacc, tacc = _both_accs(_accs(scalars, rng), acc_inf)
    jout, jdeg = J._glv_window_step(
        (jacc, jnp.zeros((1, B), jnp.int32)),
        jnp.asarray(np.array(w1, np.int32).reshape(1, B)),
        jnp.asarray(np.array(w2, np.int32).reshape(1, B)),
        *g["jax"], g["jqi"])
    tout, tdeg = T._glv_window_step(
        (tacc, torch.zeros(B, dtype=torch.bool)), torch.tensor(w1),
        torch.tensor(w2), *g["port"], g["tqi"])
    _assert_same(tout, tdeg, jout, jdeg, [True, True] + [False] * 4)


def test_comb_step_matches_jax_including_collisions(jax_parallel_fields):
    """One comb tooth (i = 2) of the G stream, then of the lambda G stream,
    on random accumulators plus crafted collisions: acc = +-(the entry) for
    the G stream (lanes 0 to 2: same, opposite, negative sign), acc = the
    lambda G entry for the lambda G stream (lane 3); lane 5 at infinity."""
    B, i = 6, 2
    rng = random.Random(25)
    d1 = [17, 200, 9, 0, 33, 5]
    sg1 = [0, 0, 1, 0, 1, 0]
    d2 = [0, 0, 0, 44, 250, 1]
    sg2 = [0, 0, 0, 1, 0, 0]
    w = 256 ** i
    scalars = [d1[0] * w, -d1[1] * w, -d1[2] * w,
               -d2[3] * w * T.LAMBDA - d1[3] * w, rng.randrange(1, N),
               rng.randrange(1, N)]
    acc_inf = [False] * (B - 1) + [True]
    jacc, tacc = _both_accs(_accs([a % N for a in scalars], rng), acc_inf)
    gx, gy, lx = (jnp.asarray(t[i]) for t in J._glv_comb())
    tgx, tgy, tlx = (t[i] for t in T._comb_on("cpu", "limbs"))
    one = _jax_one(B)
    never = jnp.zeros((1, B), jnp.int32)
    carry = (jacc, jnp.zeros((1, B), jnp.int32))
    tcarry = (tacc, torch.zeros(B, dtype=torch.bool))
    expect = [[True, True, True, False, False, False],
              [True, True, True, True, False, False]]
    for step, (d, sg, tx, ttx) in enumerate(((d1, sg1, gx, tgx),
                                             (d2, sg2, lx, tlx))):
        carry = J._glv_comb_step(
            carry, jnp.asarray(np.array(d, np.int32)),
            jnp.asarray(np.array(sg, np.int32) * 256), tx, gy, one, never)
        tcarry = T._glv_comb_step(tcarry, torch.tensor(d),
                                  torch.tensor(sg) * 256, ttx, tgy)
        _assert_same(*tcarry, *carry, expect[step])


# ---- whole verifies ---------------------------------------------------------

def test_whole_verifies_match_the_oracle_on_the_edge_corpus():
    """Both plain verifies (device split and host split) on the edge
    corpus, a wrap lane accepted only with its gate set, a q_inf lane and
    a padding lane: the degen planes equal each other, and the verdicts
    after the host re-check equal the oracle."""
    recs = edge_corpus()
    n = len(recs)
    expect = oracle_verdicts(recs)
    assert expect.count(True) > n // 2 and not all(expect)
    B = n + 1
    dev_arrays = [a.copy() for a in E.pack_records_w4_bytes(recs, B)]
    host_arrays = [a.copy() for a in E.pack_records_glv(recs, B)]
    # lane 2 (valid): the true r moved to rn with the wrap gate set; lane
    # 3 (valid): the same with the gate cleared; lane 4: q_inf
    for r0, rn, wrap, qinf in ((dev_arrays[5], dev_arrays[6], dev_arrays[7],
                                dev_arrays[4]),
                               (host_arrays[10], host_arrays[11],
                                host_arrays[12], host_arrays[9])):
        for lane, gate in ((2, 1), (3, 0)):
            rn[lane] = r0[lane]
            r0[lane] ^= 0x5A
            wrap[lane] = gate
        qinf[4] = 1
    want = list(expect)
    want[3] = want[4] = False
    assert expect[2] and expect[3] and expect[4]
    ok_d, dg_d = T.ecdsa_verify_batch_glv_dev(*tensors(dev_arrays))
    ok_h, dg_h = T.ecdsa_verify_batch_glv(*tensors(host_arrays))
    assert dg_d.tolist() == dg_h.tolist()
    nd = ~dg_d
    assert ok_d[nd].tolist() == ok_h[nd].tolist()
    final = np.where(dg_d.numpy()[:n], expect, ok_d.numpy()[:n])
    assert final.tolist() == want
    assert dg_d.any()  # the crafted lane Q = G, u1 = u2 = 5
    assert not ok_d[n:].any() and not dg_d[n:].any()
    assert not ok_d[4] and not dg_d[4]


# ---- the ladder (ops/ecdsa_batch.py) ----------------------------------------

def _spy(monkeypatch, names) -> dict:
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(T, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(T, name, counted)
    return calls


RUNGS = ("ecdsa_verify_batch_glv_dev", "ecdsa_verify_batch_glv",
         "ecdsa_verify_batch_pallas_w4_bytes", "ecdsa_verify_batch_pallas_w4")


def test_default_kernel_is_glv_with_the_device_split(monkeypatch):
    """GLV is the default; -ecdsakernel=msm is accepted, and the ECDSA
    lanes under it take the same GLV device-split rung (the MSM batch
    equation is Schnorr's), as in the reference."""
    assert E.ECDSA_KERNELS == ("glv", "w4", "msm")
    assert E.active_kernel() == "glv"
    calls = _spy(monkeypatch, RUNGS)
    recs = make_records(31, 12)
    got = E.verify_batch(recs, backend="device")
    assert got.tolist() == oracle_verdicts(recs)
    assert calls == {RUNGS[0]: 1, RUNGS[1]: 0, RUNGS[2]: 0, RUNGS[3]: 0}
    st = E.STATS
    assert st.glv_dev_dispatches == 1 and st.glv_dispatches == 1
    assert st.glv_dev_fallbacks == 0 and st.glv_fallbacks == 0
    assert st.buckets_used == {1024: 1}  # the GLV legs' floor bucket
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    assert E._PW_GLV_DEV.signatures.get((1024,), 0) >= 1
    monkeypatch.setattr(E, "_KERNEL", None)
    assert E.set_kernel("msm") == "msm" and E.active_kernel() == "msm"
    got = E.verify_batch(recs, backend="device")
    assert got.tolist() == oracle_verdicts(recs)
    assert calls == {RUNGS[0]: 2, RUNGS[1]: 0, RUNGS[2]: 0, RUNGS[3]: 0}
    assert st.glv_dev_dispatches == 2 and st.msm_dispatches == 0


@pytest.mark.parametrize("site,rung", [(E.GLV_DEV_SITE, 1), (E.GLV_SITE, 3)],
                         ids=["ecdsa_glv_dev", "ecdsa_glv"])
def test_injected_faults_step_down_one_rung(monkeypatch, site, rung):
    """fail-always on ecdsa_glv_dev: the device-split leg steps down to the
    host split; on ecdsa_glv (which both GLV legs consult): to w4 (12
    records and 2 known-answer lanes take w4's plane entry)."""
    recs = make_records(32, 12)
    arm(monkeypatch, "fail-always", site)
    calls = _spy(monkeypatch, RUNGS)
    got = E.verify_batch(recs, backend="device")
    assert got.tolist() == oracle_verdicts(recs)
    assert [calls[r] for r in RUNGS] == [int(i == rung) for i in range(4)]
    st = E.STATS
    assert st.glv_dev_fallbacks == 1
    assert st.glv_fallbacks == int(site == E.GLV_SITE)
    assert st.glv_dispatches == int(site == E.GLV_DEV_SITE)
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0


def test_a_poisoned_glv_mask_is_caught_by_the_known_answer_lanes(
        monkeypatch):
    recs = make_records(33, 10)
    arm(monkeypatch, "poison-output", E.GLV_DEV_SITE)
    got = E.verify_batch(recs, backend="device")
    assert got.tolist() == oracle_verdicts(recs)
    assert E.STATS.kat_failures == 1 and E.STATS.fault_fallback_sigs == 10


def test_a_failing_glv_kernel_raises_and_nothing_serves_in_its_place(
        monkeypatch):
    """Not injected: a failed launch in either GLV leg (the host split
    reached through an injected fault on the device split), and a mask
    that lies, raise KernelUnavailable through dispatch_batch and
    dispatch_packed; no w4 kernel, host split or CPU verify runs
    instead."""
    def broken(*_a):
        raise RuntimeError("launch failed: too many resources requested")

    def liar(*a):
        none = torch.zeros(a[-2].shape[0], dtype=torch.bool)
        return none, none.clone()

    calls = _spy(monkeypatch, RUNGS[1:])
    recs = make_records(34, 9)
    blobs = E.records_to_blobs(recs)
    monkeypatch.setattr(T, "ecdsa_verify_batch_glv_dev", broken)
    with pytest.raises(T.KernelUnavailable, match="too many resources"):
        E.dispatch_batch(recs, backend="device")
    with pytest.raises(T.KernelUnavailable, match="too many resources"):
        E.dispatch_packed(*blobs, backend="device")
    packer = E.LanePacker(backend="device", lanes=4)
    with pytest.raises(T.KernelUnavailable):
        packer.add(recs)
    # the host-split rung, reached by an injected fault on the device
    # split, fails on its own
    arm(monkeypatch, "fail-always", E.GLV_DEV_SITE)
    monkeypatch.setattr(T, "ecdsa_verify_batch_glv", broken)
    with pytest.raises(T.KernelUnavailable, match="glv_verify"):
        E.dispatch_batch(recs, backend="device")
    with pytest.raises(T.KernelUnavailable, match="glv_verify"):
        E.dispatch_packed(*blobs, backend="device")
    for var in ("BCP_FAULT_MODE", "BCP_FAULT_OPS"):
        monkeypatch.delenv(var)
    faults.INJECTOR.reload()
    monkeypatch.setattr(T, "ecdsa_verify_batch_glv_dev", liar)
    handle = E.dispatch_batch(recs, backend="device")
    with pytest.raises(T.KernelUnavailable, match="known-answer"):
        handle.result()
    assert calls == {name: 0 for name in RUNGS[1:]}
    st = E.STATS
    assert st.glv_dev_fallbacks == 2 and st.glv_fallbacks == 0
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    assert st.kat_failures == 1
    assert tdispatch.breaker("ecdsa").snapshot()["fallback_calls"] == 0


def test_dispatch_packed_runs_the_glv_device_split():
    recs = make_records(35, 24)
    pub, rs, msg, rn, wrap = E.records_to_blobs(recs)
    handle = E.dispatch_packed(pub, rs, msg, rn, wrap, backend="device")
    assert handle._bucket == 1024
    got = handle.result()
    assert got.tolist() == oracle_verdicts(recs)
    if native.available():
        cpu = native.ecdsa_verify_batch_blobs(pub.tobytes(), rs.tobytes(),
                                              msg.tobytes(), len(msg))
        assert got.tolist() == list(map(bool, cpu))
    assert E.STATS.glv_dev_dispatches == 1 and E.STATS.cpu_fallback_sigs == 0


def test_validate_chain_under_glv_matches_the_cpu_engine(tmp_path):
    d = str(tmp_path)
    gen = sigchain.generate(d, 200, inputs_per_tx=20, txs_per_block=5,
                            fan_k=100, tip_inputs=4)
    launches = dict(T.LAUNCHES)
    cs, dev = sigchain.validate_chain(d, "device", depth=8)  # the default
    st = E.STATS
    assert st.glv_dev_dispatches >= 1 and st.glv_dev_dispatches == \
        st.dispatches
    assert st.sigs_verified >= gen["sigs"]
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    assert T.LAUNCHES == launches  # the CPU device launches nothing
    bad = CBlock.from_bytes(gen["tampered_tip"])
    cs.process_new_block(bad)
    assert cs.block_index[bad.get_hash()].status & BlockStatus.FAILED_VALID
    assert st.reject_confirm_sigs >= 1
    _cs, cpu = sigchain.validate_chain(d, "cpu", depth=1)
    assert dev["digest"] == cpu["digest"] and dev["best"] == cpu["best"]


def test_dispatch_packed_under_msm_takes_the_w4_byte_rung(monkeypatch):
    """Under -ecdsakernel=msm the packed entry gates the GLV legs as the
    reference does (``active_kernel() == "glv" and glv_enabled()``, with
    ``glv_dev_enabled()`` for the device split:
    bitcoincashplus_tpu/ops/ecdsa_batch.py:1868 and :1905): packed ECDSA
    blobs reach the w4 byte rung once and no GLV rung. With
    BCP_SECP_PALLAS=0 the packed leg is off under msm, and the blobs take
    the record route, where the reference's dispatch_batch sends ECDSA
    lanes under msm to the GLV device split. Verdicts are the oracle's."""
    recs = make_records(36, 14)
    blobs = E.records_to_blobs(recs)
    calls = _spy(monkeypatch, RUNGS + ("ecdsa_verify_batch_jit",))
    E.set_kernel("msm")
    got = E.dispatch_packed(*blobs, backend="device").result()
    assert got.tolist() == oracle_verdicts(recs)
    assert calls == {RUNGS[0]: 0, RUNGS[1]: 0, RUNGS[2]: 1, RUNGS[3]: 0,
                     "ecdsa_verify_batch_jit": 0}
    st = E.STATS
    assert st.glv_dispatches == 0 and st.glv_dev_dispatches == 0
    assert st.buckets_used == {1024: 1}
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    monkeypatch.setenv("BCP_SECP_PALLAS", "0")
    got = E.dispatch_packed(*blobs, backend="device").result()
    assert got.tolist() == oracle_verdicts(recs)
    assert calls == {RUNGS[0]: 1, RUNGS[1]: 0, RUNGS[2]: 1, RUNGS[3]: 0,
                     "ecdsa_verify_batch_jit": 0}
    assert st.glv_dev_dispatches == 1 and st.msm_dispatches == 0
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
