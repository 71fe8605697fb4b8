"""Differential tests: the port's w4 verify (ops/secp256k1.py of
bitcoincashplus_tpu_torch, plain PyTorch version on the CPU) against the
JAX package's w4 functions and its oracle.

Inputs are made from seeds with Python's random / numpy and fed to both
packages; field values are compared by their canonical value mod p, and
verdict planes exactly (all of this is integer arithmetic).

The JAX table build, window step and final check run eagerly with
BCP_SECP_PARALLEL=1 — the JAX package's own switch to its scan-free field
forms (the forms its Pallas kernels trace) — because their jit compile on
the CPU backend costs minutes. The jit of the whole ``_verify_core_w4``
(minutes of XLA compile on the CPU) is the one ``slow`` test.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu.ops import ecdsa_batch as jeb
from bitcoincashplus_tpu.ops import secp256k1 as J
from bitcoincashplus_tpu.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as teb
from bitcoincashplus_tpu_torch.ops import secp256k1 as T

P, N = oracle.P, oracle.N


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain verify's tensors are small, and the
    suite runs in several worker processes at once — a thread pool per
    worker only oversubscribes the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- helpers ----------------------------------------------------------------

def jax_limbs(vals):
    return jnp.asarray(J.pack_batch_np([int(v) for v in vals]))


def jax_vals(arr):
    a = np.asarray(arr)
    return [J.from_limbs_np(a[:, k]) % P for k in range(a.shape[1])]


def port_vals(t):
    return [v % P for v in T.from_limbs(t)]


def port_limbs(vals):
    return T.to_limbs([int(v) % (1 << 256) for v in vals])


def rand_field(rng, n):
    return [rng.randrange(P) for _ in range(n)]


@pytest.fixture
def jax_parallel_fields(monkeypatch):
    monkeypatch.setenv("BCP_SECP_PARALLEL", "1")


def sig_records(rng, n):
    """Valid signatures, every third invalid; returns (records, d list)."""
    recs = []
    for i in range(n):
        d = rng.randrange(1, N)
        pub = oracle.point_mul(d, oracle.G)
        e = rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        if i % 3 == 2:
            e = (e + 1) % N
        recs.append(SigCheckRecord(pub, r, s, e))
    return recs


def degenerate_record(rng):
    """Pubkey G with message hash e = r: u1 == u2, so the first nonzero
    window adds jG to jG — an H == 0 collision. The signature is valid."""
    k = rng.randrange(1, N)
    r = oracle.point_mul(k, oracle.G)[0] % N
    s = pow(k, N - 2, N) * (2 * r) % N
    return SigCheckRecord(oracle.G, r, s, r)


# ---- field ops ----------------------------------------------------------------

class TestField:
    def test_mul_sqr_add_sub_match_jax(self):
        rng = random.Random(11)
        va, vb = rand_field(rng, 48), rand_field(rng, 48)
        va += [0, 1, P - 1, P - 1, (1 << 256) % P]
        vb += [P - 1, P - 1, P - 1, 1, 977]
        ja, jb = jax_limbs(va), jax_limbs(vb)
        ta, tb = port_limbs(va), port_limbs(vb)
        assert port_vals(T.f_mul(ta, tb)) == jax_vals(jax.jit(J.f_mul)(ja, jb))
        assert port_vals(T.f_sqr(ta)) == jax_vals(jax.jit(J.f_sqr)(ja))
        assert port_vals(T.f_carry(T.f_add(ta, tb))) == jax_vals(
            jax.jit(lambda a, b: J.f_carry(J.f_add(a, b)))(ja, jb))
        assert port_vals(T.f_carry_sub(ta, tb)) == jax_vals(
            jax.jit(J.f_carry_sub)(ja, jb))

    def test_magnitude_bounds_hold_at_the_extremes(self):
        # the largest limbs f_mul accepts (< 2^23) stay exact in int64 and
        # come out weak (< 2^17)
        big = torch.full((3, T.N_LIMBS), (1 << 23) - 1, dtype=torch.int64)
        v = T.from_limbs(big)[0]
        out = T.f_mul(big, big)
        assert int(out.max()) < (1 << 17)
        assert port_vals(out) == [v * v % P] * 3
        sub = T.f_sub(torch.zeros_like(big), torch.full_like(
            big, (1 << 21) - 33))
        assert int(sub.min()) >= 0

    def test_zero_test_and_canonical_form(self):
        rng = random.Random(12)
        va = rand_field(rng, 16)
        ta = port_limbs(va)
        assert T.f_is_zero(T.f_sub(ta, ta)).all()
        assert not T.f_is_zero(T.f_sub(ta, port_limbs(
            [(v + 1) % P for v in va]))).any()
        # v + p below 2^256 is a second representation of v
        small = [rng.randrange((1 << 32) + 977) for _ in range(8)]
        assert T.f_is_zero(T.f_sub(port_limbs([v + P for v in small]),
                                   port_limbs(small))).all()
        # the canonical form is exact 16-bit limbs below 2^256, congruent
        canon = T.f_canonical(T.f_add(ta, ta))
        assert int(canon.max()) <= T.MASK
        assert port_vals(canon) == [2 * v % P for v in va]
        got = np.asarray(jax.jit(J.f_is_zero)(jax_limbs([0, 5, P - 1])))
        assert got.tolist() == T.f_is_zero(port_limbs([0, 5, P - 1])).tolist()

    def test_limb_converters_round_trip(self):
        rng = random.Random(13)
        vals = rand_field(rng, 20) + [0, P - 1, (1 << 256) - 1]
        planes = J.pack_batch_np(vals)
        t = T.limbs_from_jax(planes)
        assert port_vals(t) == [v % P for v in vals]
        back = T.limbs_to_jax(t)
        assert back.dtype == np.uint32 and back.shape == planes.shape
        assert [J.from_limbs_np(back[:, k]) for k in range(len(vals))] == \
            [v % P for v in vals]
        # non-canonical JAX limbs (a weak value above p) convert by value
        weak = planes.copy()
        weak[0] += 5
        assert port_vals(T.limbs_from_jax(weak)) == [
            (v + 5) % P for v in vals]


# ---- byte expansions ------------------------------------------------------------

def test_byte_expansions_match_jax():
    rng = np.random.default_rng(14)
    m = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    m[0] = 0xFF
    m[1] = 0
    jw = np.asarray(J._expand_nibble_windows(jnp.asarray(m)))
    tw = T._expand_nibble_windows(torch.from_numpy(m)).numpy()
    assert np.array_equal(jw, tw)
    jl = np.asarray(J._expand_limb_cols(jnp.asarray(m)))
    tl = T._expand_limb_cols(torch.from_numpy(m))
    assert [J.from_limbs_np(jl[:, k]) for k in range(40)] == T.from_limbs(tl)
    assert np.array_equal(T.bits_to_windows_np(m, 48),
                          J.bits_to_windows_np(m, 48))


# ---- the w4 core: table, one window step, final check -----------------------------

def _jax_one(B):
    shape = (J.N_LIMBS, B)
    one = jnp.asarray(np.broadcast_to(
        J.to_limbs_np(1).reshape(J.N_LIMBS, 1), shape)).astype(jnp.uint32)
    return shape, one


def _jac(pt, z):
    """Affine point -> Jacobian (x z^2, y z^3, z)."""
    return (pt[0] * z * z % P, pt[1] * z * z * z % P, z)


@pytest.fixture(scope="module")
def tables():
    """Q tables of six lanes, built once by both packages: lanes 0 and 1
    have Q = G (the window-step test crafts collisions there), lane 4 is
    q_inf."""
    rng = random.Random(15)
    B = 6
    qs = [oracle.G, oracle.G] + [
        oracle.point_mul(rng.randrange(1, N), oracle.G) for _ in range(4)]
    q_inf = [False] * (B - 2) + [True, False]
    qx, qy = [q[0] for q in qs], [q[1] for q in qs]
    shape, one = _jax_one(B)
    jqi = jnp.asarray(np.array(q_inf, np.int32).reshape(1, B))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCP_SECP_PARALLEL", "1")
        jtab = J._w4_tables(jax_limbs(qx), jax_limbs(qy), jqi, one, shape)
    tqi = torch.tensor(q_inf)
    ttab = T._w4_tables(port_limbs(qx), port_limbs(qy), tqi)
    return {"B": B, "qs": qs, "q_inf": q_inf, "jqi": jqi, "tqi": tqi,
            "one": one, "jax": jtab, "port": ttab}


def test_table_build_matches_jax(tables):
    B, qs, q_inf = tables["B"], tables["qs"], tables["q_inf"]
    g_tab, q_tab = tables["jax"]
    tg, tq = tables["port"]
    live = [i for i in range(B) if not q_inf[i]]
    for j in range(1, 16):
        assert port_vals(tg[0][j:j + 1]) == jax_vals(g_tab[j][0])[:1]
        assert port_vals(tg[1][j:j + 1]) == jax_vals(g_tab[j][1])[:1]
        for k, c in enumerate("XYZ"):
            tv, jv = port_vals(tq[k][j]), jax_vals(q_tab[j][c])
            assert [tv[i] for i in live] == [jv[i] for i in live], (j, c)
        assert tq[3][j].tolist() == np.asarray(
            q_tab[j]["inf"]).reshape(B).astype(bool).tolist()
        # and the entries are jQ (finite lanes)
        for lane in live:
            x, y, z = (port_vals(tq[k][j])[lane] for k in range(3))
            zi = pow(z, P - 2, P)
            assert (x * zi * zi % P, y * zi * zi * zi % P) == \
                oracle.point_mul(j, qs[lane])


def test_window_step_matches_jax_including_collisions(tables,
                                                      jax_parallel_fields):
    """One window step on random accumulators, plus crafted lanes where
    the G add (lane 0) and the Q add (lane 1, Q = G) collide (H == 0): the
    accumulators and the degen plane must match the JAX step exactly."""
    rng = random.Random(16)
    B = tables["B"]
    w1 = [5, 2, 0, 7, 15, 9]
    w2 = [3, 9, 4, 0, 11, 6]
    inv16 = pow(16, N - 2, N)
    scalars = [w1[0] * inv16 % N, (w2[1] - w1[1]) * inv16 % N] + [
        rng.randrange(1, N) for _ in range(4)]
    accs = [_jac(oracle.point_mul(a, oracle.G), rng.randrange(1, P))
            for a in scalars]
    acc_inf = [False] * (B - 1) + [True]
    jacc = {"X": jax_limbs([a[0] for a in accs]),
            "Y": jax_limbs([a[1] for a in accs]),
            "Z": jax_limbs([a[2] for a in accs]),
            "inf": jnp.asarray(np.array(acc_inf, np.int32).reshape(1, B))}
    jw1 = jnp.asarray(np.array(w1, np.int32).reshape(1, B))
    jw2 = jnp.asarray(np.array(w2, np.int32).reshape(1, B))
    g_tab, q_tab = tables["jax"]
    (jout, jdeg) = J._w4_window_step(
        (jacc, jnp.zeros((1, B), jnp.int32)), jw1, jw2, g_tab, q_tab,
        tables["jqi"], tables["one"], jnp.zeros((1, B), jnp.int32))

    tg, tq = tables["port"]
    tacc = tuple(port_limbs([a[k] for a in accs]) for k in range(3)) + (
        torch.tensor(acc_inf),)
    tout, tdeg = T._w4_window_step(
        (tacc, torch.zeros(B, dtype=torch.bool)), torch.tensor(w1),
        torch.tensor(w2), tg, tq, tables["tqi"])

    deg = np.asarray(jdeg).reshape(B).astype(bool)
    assert tdeg.tolist() == deg.tolist()
    assert deg[0] and deg[1] and not deg[2:].any()
    finite = ~np.asarray(jout["inf"]).reshape(B).astype(bool)
    assert tout[3].tolist() == (~finite).tolist()
    for k, c in enumerate("XYZ"):
        tv, jv = port_vals(tout[k]), jax_vals(jout[c])
        assert [tv[i] for i in range(B) if finite[i]] == \
            [jv[i] for i in range(B) if finite[i]], c


def test_verify_final_matches_jax(jax_parallel_fields):
    # six lanes, as in the tests above: eager JAX compiles per shape
    rng = random.Random(17)
    B = 6
    zs = [rng.randrange(1, P) for _ in range(B)]
    rs = [rng.randrange(1, N) for _ in range(B)]
    # lanes: 0 ok via r0; 1 ok via rn with wrap; 2 rn matches, wrap off;
    # 3 no match; 4 acc at infinity; 5 q_inf
    r0 = list(rs)
    rn = [rng.randrange(1, P) for _ in range(B)]
    xs = [r * z * z % P for r, z in zip(rs, zs)]
    for i in (1, 2):
        rn[i], r0[i] = rs[i], (rs[i] + 1) % P
    xs[3] = (xs[3] + 1) % P
    wrap = [False, True, False, True, False, False]
    acc_inf = [i == 4 for i in range(B)]
    q_inf = [i == 5 for i in range(B)]
    degen = [True, False, False, False, False, True]
    ys = rand_field(rng, B)
    jacc = {"X": jax_limbs(xs), "Y": jax_limbs(ys), "Z": jax_limbs(zs),
            "inf": jnp.asarray(np.array(acc_inf, np.int32).reshape(1, B))}
    jok, jdg = J._verify_final(
        jacc, jnp.asarray(np.array(degen, np.int32).reshape(1, B)),
        jnp.asarray(np.array(q_inf, np.int32).reshape(1, B)),
        jax_limbs(r0), jax_limbs(rn),
        jnp.asarray(np.array(wrap, np.uint32).reshape(1, B)))
    tacc = (port_limbs(xs), port_limbs(ys), port_limbs(zs),
            torch.tensor(acc_inf))
    tok, tdg = T._verify_final(tacc, torch.tensor(degen),
                               torch.tensor(q_inf), port_limbs(r0),
                               port_limbs(rn), torch.tensor(wrap))
    assert tok.tolist() == np.asarray(jok).reshape(B).astype(bool).tolist()
    assert tdg.tolist() == np.asarray(jdg).reshape(B).astype(bool).tolist()
    assert tok.tolist() == [True, True, False, False, False, False]
    assert tdg.tolist() == [True, False, False, False, False, False]


# ---- the whole verify -------------------------------------------------------------

def _batch(rng, n_sigs):
    """Records with invalid and degenerate lanes, packed for both entries,
    plus crafted q_inf and wrap lanes. Returns (records, bytes arrays,
    plane arrays, lane kinds)."""
    recs = sig_records(rng, n_sigs)
    recs[1] = degenerate_record(rng)
    recs[4] = degenerate_record(rng)
    B = 32
    be = [a.copy() for a in jeb.pack_records_w4_bytes(recs, 1024)]
    pl = [a.copy() for a in jeb.pack_records_w4(recs, B)]
    q_inf_lanes, wrap_on, wrap_off = [6], [7, 9], [10]
    for arrs, kind in ((be, "bytes"), (pl, "planes")):
        u1, u2, qx, qy, qi, r0, rn, wr = arrs
        qi[q_inf_lanes] = 1
        for lanes, flag in ((wrap_on, 1), (wrap_off, 0)):
            if kind == "bytes":
                rn[lanes] = r0[lanes]
                r0[lanes] ^= np.uint8(0x3C)
            else:
                rn[:, lanes] = r0[:, lanes]
                r0[:, lanes] ^= np.uint32(0x0F0)
            wr[lanes] = flag
    return recs, be, pl, {"q_inf": q_inf_lanes, "wrap_on": wrap_on,
                          "wrap_off": wrap_off}


def _expected(recs, kinds, n_lanes):
    oracle_ok = np.asarray(jeb._verify_cpu(recs), bool)
    exp = np.zeros(n_lanes, bool)
    exp[:len(recs)] = oracle_ok
    exp[kinds["q_inf"]] = False
    exp[kinds["wrap_off"]] = False
    return exp, oracle_ok


def test_whole_verify_matches_oracle_both_entries():
    """The plain verify through both wrappers (bytes and planes inputs, as
    the JAX packers emit them) against the JAX package's oracle
    (ecdsa_batch._verify_cpu) after the host re-check of degen lanes:
    invalid, wrap, q_inf, degenerate and padding lanes."""
    rng = random.Random(18)
    recs, be, pl, kinds = _batch(rng, 24)
    exp, oracle_ok = _expected(recs, kinds, 32)

    ok_p, dg_p = T.ecdsa_verify_batch_pallas_w4(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in pl])
    assert dg_p.tolist()[:8] == [False, True, False, False, True, False,
                                 False, False]
    final = np.where(dg_p.numpy(), np.pad(oracle_ok, (0, 8)), ok_p.numpy())
    assert final.tolist() == exp.tolist()
    assert not ok_p[24:].any()  # padding lanes

    # the byte entry's plain version on the same records (the wrapper at
    # its 1024-lane bucket runs in test_torch_ecdsa_batch.py)
    ok_b, dg_b = T.w4_verify_bytes_plain(
        *[torch.from_numpy(np.ascontiguousarray(a[:32])) for a in be])
    assert dg_b.tolist() == dg_p.tolist()
    assert ok_b[~dg_b].tolist() == ok_p[~dg_p].tolist()


def test_wrappers_reject_bad_inputs_and_non_cpu_tensors():
    rng = random.Random(19)
    recs = sig_records(rng, 3)
    arrays = [torch.from_numpy(a) for a in
              teb.pack_records_w4_bytes(recs, 1024)]
    with pytest.raises(ValueError):
        T.ecdsa_verify_batch_pallas_w4_bytes(*[a[:1000] for a in arrays])
    with pytest.raises(ValueError):
        T.ecdsa_verify_batch_pallas_w4_bytes(
            *arrays[:2], arrays[2].to(torch.int32), *arrays[3:])
    # a tensor on any device but the CPU launches the kernel or raises —
    # never the plain version
    with pytest.raises(T.KernelUnavailable):
        T.ecdsa_verify_batch_pallas_w4_bytes(*[a.to("meta") for a in arrays])
    planes = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              teb.pack_records_w4(recs, 32)]
    with pytest.raises(T.KernelUnavailable):
        T.ecdsa_verify_batch_pallas_w4(*[a.to("meta") for a in planes])


def test_kernel_g_table_matches_oracle():
    """csrc/w4_verify.cu carries jG (j = 1..15) as literals: hold them
    against the oracle."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(T.__file__), "..", "csrc",
                            "w4_verify.cu")).read()
    body = src[src.index("c_gtab[16][2][8] = {"):]
    body = body[:body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert len(words) == 15 * 16
    pt = oracle.G
    for j in range(15):
        row = words[16 * j:16 * j + 16]
        x = sum(w << (32 * i) for i, w in enumerate(row[:8]))
        y = sum(w << (32 * i) for i, w in enumerate(row[8:]))
        assert (x, y) == pt, j + 1
        pt = oracle.point_add(pt, oracle.G)


@pytest.mark.slow
def test_verify_core_w4_jit_matches_port():
    """The JAX _verify_core_w4 under plain jax.jit (outside pallas_call, as
    tools/roofline.py traces it) against the port's plain verify at 16
    lanes, degen plane included. Minutes of XLA compile on the CPU
    backend, hence slow."""
    rng = random.Random(20)
    recs = sig_records(rng, 14)
    recs[3] = degenerate_record(rng)
    u1w, u2w, qx, qy, q_inf, r0, rn, wrap = jeb.pack_records_w4(recs, 16)
    B = 16

    def core(u1w, u2w, qx, qy, qi, r0, rn, wr):
        return J._verify_core_w4(
            lambda i: jax.lax.dynamic_slice_in_dim(u1w, i, 1, 0),
            lambda i: jax.lax.dynamic_slice_in_dim(u2w, i, 1, 0),
            qx, qy, qi, r0, rn, wr)

    jok, jdg = jax.jit(core)(
        jnp.asarray(u1w.astype(np.int32)), jnp.asarray(u2w.astype(np.int32)),
        jnp.asarray(qx), jnp.asarray(qy),
        jnp.asarray(q_inf.astype(np.int32).reshape(1, B)), jnp.asarray(r0),
        jnp.asarray(rn), jnp.asarray(wrap.astype(np.uint32).reshape(1, B)))
    tok, tdg = T.ecdsa_verify_batch_pallas_w4(
        *[torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                           if a.dtype == np.uint32 else a)
          for a in (u1w, u2w, qx, qy, q_inf, r0, rn, wrap)])
    assert tdg.tolist() == np.asarray(jdg).reshape(B).astype(bool).tolist()
    assert tdg[3]
    assert tok.tolist() == np.asarray(jok).reshape(B).astype(bool).tolist()
