"""The port's Schnorr batch check (K9) on the CPU: the complete point adds
against the JAX package's (run eagerly, once each), the MSM's digit layout
against the JAX package's, the plain MSM (the kernel's schedule, standing
in for csrc/msm.cu because the tensors lie on the CPU) against the
oracle's sum_j k_j Q_j on random terms and a crafted corpus at buckets 64
and 256, the MSM rung's host functions against the JAX package's, and the
dispatch (-ecdsakernel=msm) with its canary gate, bisection, prechecks,
counters and fault rules.

The JAX MSM programs (_msm_program, _msm_partial_program,
_msm_accumulate) are never compiled or run here: their XLA compile costs
minutes on the CPU. Everything compared is integers or verdicts, so every
comparison is exact."""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu.ops import ecdsa_batch as jeb
from bitcoincashplus_tpu.ops import secp256k1 as J
from bitcoincashplus_tpu.script.interpreter import SigCheckRecord as JRecord
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import dispatch as tdispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as T
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.util import faults
from bitcoincashplus_tpu_torch.workload import sigchain

P, N, G = oracle.P, oracle.N, oracle.G


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain MSM's tensors are small, and the
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
    monkeypatch.setenv("BCP_MSM_SEED", "0x5eed")
    faults.INJECTOR.reload()
    tdispatch.reset()
    E.STATS.__init__()
    monkeypatch.setattr(E, "_KERNEL", None)
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    E.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    tdispatch.reset()


def arm(monkeypatch, mode, site):
    monkeypatch.setenv("BCP_FAULT_MODE", mode)
    monkeypatch.setenv("BCP_FAULT_OPS", site)
    faults.INJECTOR.reload()


# ---- the complete adds --------------------------------------------------------

def _jac(pt, z):
    """Affine pt (None = infinity) -> Jacobian (X, Y, Z, inf) ints."""
    if pt is None:
        return (1, 1, 0, True)
    return (pt[0] * z * z % P, pt[1] * z * z * z % P, z, False)


def _affine(X, Y, Z):
    zi = pow(Z, P - 2, P)
    return (X * zi * zi % P, Y * zi * zi * zi % P)


def _neg(pt):
    return (pt[0], P - pt[1])


def _add_cases(seed):
    """(P Jacobian, Q Jacobian) lanes side by side: generic, P == Q,
    P == -Q, P = inf, Q = inf, both inf, generic and P == Q again — Z != 1
    on both sides except where a case says Z = 1."""
    rng = random.Random(seed)
    A = oracle.point_mul(rng.randrange(1, N), G)
    B = oracle.point_mul(rng.randrange(1, N), G)
    z = [rng.randrange(2, P) for _ in range(16)]
    return [(_jac(A, z[0]), _jac(B, z[1])),
            (_jac(A, z[2]), _jac(A, z[3])),
            (_jac(A, z[4]), _jac(_neg(A), z[5])),
            (_jac(None, 1), _jac(B, z[6])),
            (_jac(A, z[7]), _jac(None, 1)),
            (_jac(None, 1), _jac(None, 1)),
            (_jac(B, 1), _jac(A, z[8])),
            (_jac(B, 1), _jac(B, 1))]


def _want(p, q):
    pa = None if p[3] else _affine(*p[:3])
    qa = None if q[3] else _affine(*q[:3])
    return oracle.point_add(pa, qa)


def _jax_point(rows):
    return {"X": jnp.asarray(J.pack_batch_np([r[0] for r in rows])),
            "Y": jnp.asarray(J.pack_batch_np([r[1] for r in rows])),
            "Z": jnp.asarray(J.pack_batch_np([r[2] for r in rows])),
            "inf": jnp.asarray([r[3] for r in rows])}


def _port_point(rows):
    return (T.to_limbs([r[0] for r in rows]), T.to_limbs([r[1] for r in rows]),
            T.to_limbs([r[2] for r in rows]),
            torch.tensor([r[3] for r in rows]))


def _jax_rows(pt):
    coords = [[v % P for v in (T.from_limbs(T.limbs_from_jax(
        np.asarray(pt[k]))))] for k in "XYZ"]
    return [(x, y, z, bool(i)) for x, y, z, i in
            zip(*coords, np.asarray(pt["inf"]).tolist())]


def _port_rows(pt):
    coords = [[v % P for v in T.from_limbs(c)] for c in pt[:3]]
    return [(x, y, z, bool(i)) for x, y, z, i in
            zip(*coords, pt[3].tolist())]


@pytest.mark.parametrize("form", ["mixed", "full"])
def test_complete_adds_match_jax_on_the_crafted_cases(form, monkeypatch):
    """The port's complete pt_add_mixed / pt_add_full against the JAX
    package's (eager, width 8, with BCP_SECP_PARALLEL=1: the JAX
    package's own switch to its scan-free field forms, the same values
    mod p, whose eager run costs seconds, not minutes): every lane's inf
    flag equal, its
    Jacobian triple equal mod p where finite, and its affine point equal
    to the oracle's P + Q."""
    monkeypatch.setenv("BCP_SECP_PARALLEL", "1")
    cases = _add_cases(11 if form == "mixed" else 12)
    if form == "mixed":
        # Q affine (Z = 1) for the mixed add
        cases = [(p, (q[0], q[1], 1, q[3]) if q[3] else
                  _jac(_affine(*q[:3]), 1)) for p, q in cases]
    ps, qs = [c[0] for c in cases], [c[1] for c in cases]
    if form == "mixed":
        jout = J.pt_add_mixed(_jax_point(ps), jnp.asarray(J.pack_batch_np(
            [q[0] for q in qs])), jnp.asarray(J.pack_batch_np(
                [q[1] for q in qs])), jnp.asarray([q[3] for q in qs]))
        qp = _port_point(qs)
        tout = T.pt_add_mixed(_port_point(ps), qp[0], qp[1], qp[3])
    else:
        jout = J.pt_add_full(_jax_point(ps), _jax_point(qs))
        tout = T.pt_add_full(_port_point(ps), _port_point(qs))
    jrows, trows = _jax_rows(jout), _port_rows(tout)
    for lane, (p, q) in enumerate(cases):
        want = _want(p, q)
        assert trows[lane][3] == jrows[lane][3] == (want is None), lane
        if want is not None:
            assert trows[lane][:3] == jrows[lane][:3], lane
            assert _affine(*trows[lane][:3]) == want, lane


# ---- the MSM -------------------------------------------------------------------

def _reference_halves(km) -> tuple:
    """The reference's glv_decompose of each (M, 32) big-endian scalar:
    (|k1| (M, 16) big-endian bytes, n1, |k2|, n2)."""
    rows = [J.glv_decompose(int.from_bytes(bytes(k), "big")) for k in km]
    mags = [np.frombuffer(b"".join(r[i].to_bytes(16, "big") for r in rows),
                          np.uint8).reshape(len(rows), 16) for i in (0, 2)]
    return mags[0], [r[1] for r in rows], mags[1], [r[3] for r in rows]


def test_digit_and_limb_layout_match_jax():
    """The walk's digits: the MSB-first 4-bit windows
    (J._expand_nibble_windows) of the reference's split halves, |k1| of
    term j at split term j and |k2| at M + j, stream-major; the stream
    counts of the MSM buckets keep every walk at 32 split terms up to
    8,192 terms, 64 at 16,384."""
    rng = np.random.default_rng(3)
    km = rng.integers(0, 256, (256, 32), dtype=np.uint8)
    K = T.msm_streams(256)
    m1, _n1, m2, _n2 = _reference_halves(km)
    win = np.asarray(J._expand_nibble_windows(jnp.asarray(
        np.concatenate([m1, m2]))))                      # (32, 2M)
    want = win.reshape(32, K, 512 // K).transpose(1, 0, 2).reshape(
        K * 32, 512 // K)
    assert np.array_equal(T.msm_digits(torch.from_numpy(km)).numpy(), want)
    assert [T.msm_streams(m) for m in jeb._MSM_BUCKETS] == \
        [4, 16, 64, 256, 512, 512]
    assert [2 * m // T.msm_streams(m) for m in jeb._MSM_BUCKETS] == \
        [32] * 5 + [64]
    xm = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    jl = T.limbs_from_jax(np.asarray(J._expand_limb_cols(jnp.asarray(xm))))
    tl = T._expand_limb_cols(torch.from_numpy(xm))
    assert [v % P for v in T.from_limbs(jl)] == \
        [v % P for v in T.from_limbs(tl)]


def test_msm_split_matches_the_reference():
    """msm_split_plain (csrc/msm.cu's msm_split) on the edge scalars 0, 1,
    n - 1, lambda, lambda + 1 and seeded random ones: each half's
    magnitude and sign equal to the reference's glv_decompose, k1 +
    lambda k2 == k (mod n); term j keeps (x, +-y), term M + j is
    (beta x, +-y), each y negated where its half is negative."""
    rng = random.Random(5)
    ks = [0, 1, N - 1, J.LAMBDA, J.LAMBDA + 1] + [rng.randrange(N)
                                                   for _ in range(11)]
    M = len(ks)
    pts = [oracle.point_mul(rng.randrange(1, N), G) for _ in range(M)]

    def mat(vals):
        return torch.from_numpy(np.frombuffer(b"".join(
            v.to_bytes(32, "big") for v in vals), np.uint8).reshape(M, 32)
            .copy())

    km = mat(ks)
    x, y, inf, win = T.msm_split_plain(mat([p[0] for p in pts]),
                                       mat([p[1] for p in pts]),
                                       torch.zeros(M, dtype=torch.uint8), km)
    assert not inf.any() and win.shape == (2 * M, 32)
    mags = [sum(int(d) << (4 * (31 - i)) for i, d in enumerate(row))
            for row in win.tolist()]
    xs = [v % P for v in T.from_limbs(x)]
    ys = [v % P for v in T.from_limbs(y)]
    m1, n1, m2, n2 = _reference_halves(km.numpy())
    for j, k in enumerate(ks):
        a, b = mags[j], mags[M + j]
        assert (a, b) == (int.from_bytes(bytes(m1[j]), "big"),
                          int.from_bytes(bytes(m2[j]), "big")), k
        k1 = -a if n1[j] else a
        k2 = -b if n2[j] else b
        assert (k1 + J.LAMBDA * k2 - k) % N == 0, k
        assert xs[j] == pts[j][0] and xs[M + j] == T.BETA * pts[j][0] % P
        assert ys[j] == (P - pts[j][1] if n1[j] else pts[j][1])
        assert ys[M + j] == (P - pts[j][1] if n2[j] else pts[j][1])


def _mat(vals, M):
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(M, 32).copy()


def _terms(logs, scal, flag, rng) -> tuple:
    """Numpy (xm, ym, inf8, km) of terms c_j G (flagged terms: garbage
    coordinates) and the affine sum (None: infinity)."""
    M = len(logs)
    total = sum(s * c for s, c, f in zip(scal, logs, flag) if not f) % N
    known = {}  # log -> point: consecutive logs cost one affine add
    rows = []
    for j in range(M):
        c = logs[j]
        if flag[j]:
            rows.append((rng.getrandbits(256), rng.getrandbits(256)))
            continue
        if c not in known:
            if (N - c) % N in known:
                x, y = known[(N - c) % N]
                known[c] = (x, P - y)
            elif (c - 1) % N in known:
                known[c] = oracle.point_add(known[(c - 1) % N], G)
            else:
                known[c] = oracle.point_mul(c, G)
        rows.append(known[c])
    return (_mat([r[0] for r in rows], M), _mat([r[1] for r in rows], M),
            np.asarray(flag, np.uint8), _mat(scal, M),
            oracle.point_mul(total, G) if total else None)


def msm_corpus(M: int, seed: int, zero_sum: bool) -> tuple:
    """An M-term MSM with known discrete logs (Q_j = c_j G): random terms
    and the crafted corpus on the walk's streams (original terms o S ..
    (o + 1) S - 1 are stream o's |k1| halves and stream o + K/2's |k2|
    halves, S = 2M / K): one point four times under one scalar at the head
    of stream 0 (its buckets meet P == -Q, then P == Q), a zero scalar,
    n - 1, flagged padding with garbage coordinates, a copy of stream 0
    in stream K/4 (the second merge level meets P == Q), and with K >= 8
    the negation of stream 1 in stream K/4 + 1 (P == -Q); with zero_sum one
    scalar (and its copy) makes the sum the point at infinity. Returns
    numpy (xm, ym, inf8, km) and the affine sum (None: inf)."""
    rng = random.Random(seed)
    K = T.msm_streams(M)
    S = 2 * M // K
    logs, flag = [0] * M, [False] * M
    scal = [rng.randrange(1, N) for _ in range(M)]
    for o in range(K // 2):
        c = rng.randrange(1, N)
        for t in range(S):
            logs[o * S + t] = (c + t) % N
            flag[o * S + t] = t >= S - (3 if o == 0 else 1)
    logs[1], logs[2], logs[3] = N - logs[0], logs[0], logs[0]
    scal[1] = scal[2] = scal[3] = scal[0]
    scal[4], scal[5] = 0, N - 1
    copies = {K // 4: (0, 1)}
    if K >= 8:
        copies[K // 4 + 1] = (1, -1)
    for o, (src, sign) in copies.items():
        for t in range(S):
            j, i = o * S + t, src * S + t
            logs[j] = logs[i] if sign > 0 else N - logs[i]
            scal[j], flag[j] = scal[i], flag[i]
    if zero_sum:
        last = S - 4
        twins = (last, (K // 4) * S + last)
        rest = sum(scal[j] * logs[j] for j in range(M)
                   if not flag[j] and j not in twins) % N
        s = (-rest * pow(2 * logs[last], N - 2, N)) % N
        scal[last] = scal[twins[1]] = s
    return _terms(logs, scal, flag, rng)


def msm_tree_corpus(M: int, seed: int) -> tuple:
    """A sparse crafted MSM (the other terms flagged) whose scalars are
    below 2^112, so that each |k2| half is 0 and adds nothing: at the head
    of stream 0 one point four times under one scalar whose windows 4 ..
    20 are nonzero (the walk meets P == -Q and P == Q); window 22's bucket
    1 holds U in stream 0 and in stream K/4, window 24's V and -V (the
    second merge level meets P == Q and P == -Q); window 31's buckets 1
    and 3 hold Q = -8 R and window 30's buckets 5 and 7 R and -R (the
    bit sums' first adds meet P == Q and P == -Q); 16 W_30 == W_31 and
    16 W_28 == -W_29 (the window tree's first level meets P == Q and
    P == -Q). Returns what msm_corpus returns."""
    rng = random.Random(seed)
    K = T.msm_streams(M)
    S = 2 * M // K
    logs, scal, flag = [0] * M, [0] * M, [True] * M
    slots = {0: iter(range(S)), K // 4: iter(range(K // 4 * S, K // 4 * S
                                                   + S))}

    def put(c, k, stream=0):
        j = next(slots[stream])
        logs[j], scal[j], flag[j] = c % N, k, False

    c = rng.randrange(1, N)
    kw = sum(rng.randrange(1, 16) << (4 * (31 - w)) for w in range(4, 21))
    for sign in (1, -1, 1, 1):
        put(sign * c, kw)
    u, v = rng.randrange(1, N), rng.randrange(1, N)
    put(u, 1 << 4 * (31 - 22))
    put(u, 1 << 4 * (31 - 22), stream=K // 4)
    put(v, 1 << 4 * (31 - 24))
    put(-v, 1 << 4 * (31 - 24), stream=K // 4)
    r = rng.randrange(1, N)
    put(-8 * r, 1)
    put(-8 * r, 3)
    put(r, 5 << 4)
    put(-r, 7 << 4)
    w = rng.randrange(1, N)
    put(w, 1 << 12)
    put(-16 * w, 1 << 8)
    for k in scal:
        assert k < 1 << 112 and J.glv_decompose(k)[2] == 0
    return _terms(logs, scal, flag, rng)


@pytest.mark.parametrize("M,zero_sum", [(64, False), (64, True),
                                        (256, False), (256, True)])
def test_plain_msm_matches_the_oracle_sum(M, zero_sum, monkeypatch):
    """msm_corpus through the wrappers (the plain version on the CPU):
    the oracle's sum and verdict, and the special cases the corpus
    crafts, counted by the plain version's complete adds."""
    tally = {}
    plain = T.msm_accumulate_plain
    monkeypatch.setattr(T, "msm_accumulate_plain",
                        lambda *a: plain(*a, tally=tally))
    xm, ym, inf8, km, want = msm_corpus(M, 20 + M, zero_sum)
    assert (want is None) == zero_sum
    (X, Y, Z), inf = T.msm_partial_point(xm, ym, inf8, km)
    assert inf == zero_sum
    if not zero_sum:
        assert 0 <= min(X, Y, Z) and max(X, Y, Z) < P
        assert _affine(X, Y, Z) == want
    else:
        assert (X, Y, Z) == (1, 1, 0)
    if M == 64 and zero_sum:  # the dispatch tests read both verdicts
        verdict = T.schnorr_msm_is_infinity(xm, ym, inf8, km)
        assert verdict.dtype == np.uint32 and verdict.shape == (1,)
        assert int(verdict[0]) == 1
    assert T.LAUNCHES["msm"] == T.LAUNCHES["msm_partial"] == 0
    assert tally["walk"]["same"] and tally["walk"]["opposite"]
    assert tally["merge"]["same"]
    assert bool(tally["merge"]["opposite"]) == (M >= 128)


@pytest.mark.parametrize("M", [64, 256])
def test_plain_msm_meets_every_special_case_in_every_stage(M):
    """msm_tree_corpus: the plain version's complete adds meet P == Q and
    P == -Q in the walk, a merge, the bucket reduction and the window
    tree, and the sum is the oracle's."""
    xm, ym, inf8, km, want = msm_tree_corpus(M, 40 + M)
    tally = {}
    ts = [torch.from_numpy(a) for a in (xm, ym, inf8, km)]
    (X, Y, Z), inf = T._point_result(T.msm_accumulate_plain(*ts,
                                                            tally=tally))
    assert not inf and _affine(X, Y, Z) == want
    for stage in ("walk", "merge", "reduce", "combine"):
        assert tally[stage]["same"] and tally[stage]["opposite"], stage


def test_msm_wrappers_reject_bad_inputs():
    xm = torch.zeros(65, 32, dtype=torch.uint8)
    inf8 = torch.ones(65, dtype=torch.uint8)
    with pytest.raises(ValueError):  # 130 split terms, 4 streams
        T.schnorr_msm_is_infinity(xm, xm, inf8, xm)
    xm, inf8 = xm[:64], inf8[:64]
    with pytest.raises(ValueError):
        T.msm_partial_point(xm, xm, inf8, xm.to(torch.int32))
    with pytest.raises(ValueError):
        T.msm_partial_point(xm, xm[:32], inf8, xm)


# ---- the MSM rung's host functions -----------------------------------------------

_SIGNERS = []


def _srecord(i, good=True):
    """A Schnorr record over a seeded digest, by one of four keys
    (workload/sigchain.SchnorrSigner: oracle.schnorr_sign's signature,
    held equal to it in tests/test_torch_schnorr_chain.py)."""
    if not _SIGNERS:
        _SIGNERS.extend(sigchain.SchnorrSigner(0x3333 + k) for k in range(4))
    sg = _SIGNERS[i % 4]
    e = int.from_bytes(hashlib.sha256(b"msm%d" % i).digest(), "big") % N
    r, s = sg.sign(e)
    return SigCheckRecord(sg.pub, r, s, e if good else (e + 1) % N,
                          algo="schnorr")


def _oracle(recs):
    return [oracle.schnorr_verify(r.pubkey, r.r, r.s, r.msg_hash)
            for r in recs]


def test_host_functions_match_the_reference():
    rng = random.Random(7)
    terms = [(rng.randrange(P), rng.randrange(P), rng.randrange(N))
             for _ in range(37)]
    for b in (37, 64):
        for ours, theirs in zip(E._msm_pack(terms, b),
                                jeb._msm_pack(terms, b)):
            assert ours.dtype == theirs.dtype
            assert np.array_equal(ours, theirs)
        assert E._msm_bucket_for(b) == jeb._msm_bucket_for(b)
    for m in (1, 64, 65, 256, 4093, 16384):
        assert E._msm_bucket_for(m) == jeb._msm_bucket_for(m)
    with pytest.raises(ValueError):
        E._msm_bucket_for(16385)
    assert (E._MSM_BUCKETS, E.MSM_SHAPE_BUDGET, E.MSM_MAX_RECORDS,
            E.MSM_MIN_BATCH, E.MSM_SITE) == (
        jeb._MSM_BUCKETS, jeb.MSM_SHAPE_BUDGET, jeb.MSM_MAX_RECORDS,
        jeb.MSM_MIN_BATCH, jeb.MSM_SITE)
    good = _srecord(1)
    assert _oracle([good]) == [True]
    x = 2
    while oracle.schnorr_lift_x(x) is not None:
        x += 1
    for r, s, pub in ((good.r, good.s, good.pubkey), (x, good.s, good.pubkey),
                      (P, good.s, good.pubkey), (good.r, N, good.pubkey),
                      (good.r, good.s, None), (0, 0, good.pubkey)):
        ours = E._schnorr_precheck(SigCheckRecord(pub, r, s, 5,
                                                  algo="schnorr"))
        theirs = jeb._schnorr_precheck(JRecord(pub, r, s, 5, algo="schnorr"))
        assert ours == theirs
        # the oracle rejects every record the precheck drops
        assert ours is not None or not oracle.schnorr_verify(pub, r, s, 5)
    for ours, theirs in zip(E._schnorr_kat_records(),
                            jeb._schnorr_kat_records()):
        assert (ours.pubkey, ours.r, ours.s, ours.msg_hash, ours.algo) == (
            theirs.pubkey, theirs.r, theirs.s, theirs.msg_hash, theirs.algo)
    assert E._msm_rng().getrandbits(128) == jeb._msm_rng().getrandbits(128)


# ---- the dispatch (-ecdsakernel=msm) --------------------------------------------

def _msm(recs):
    return E.dispatch_batch(recs, backend="device", kernel="msm").result()


def test_an_all_good_batch_is_accepted_on_the_device():
    recs = [_srecord(100 + i) for i in range(12)]
    got = _msm(recs)
    assert got.all()
    st = E.STATS
    assert st.msm_batches_accepted == 1 and st.msm_dispatches == 3
    assert st.schnorr_sigs == 12 and st.schnorr_cpu_sigs == 0
    assert st.cpu_fallback_sigs == 0 and st.msm_bisects == 0
    assert E.kernel_info()["msm"]["dispatches"] == 3
    assert E._PW_MSM.signatures.get((64,), 0) == 3


@pytest.mark.parametrize("pos", [0, 6, 11], ids=["first", "middle", "last"])
def test_one_forged_signature_bisects_to_the_oracles_verdicts(pos):
    recs = [_srecord(300 + i) for i in range(12)]
    recs[pos] = SigCheckRecord(recs[pos].pubkey, recs[pos].r,
                               (recs[pos].s + 1) % N, recs[pos].msg_hash,
                               algo="schnorr")
    got = _msm(recs)
    assert got.tolist() == [i != pos for i in range(12)]
    st = E.STATS
    assert st.msm_batches_rejected == 1 and st.msm_bisects == 1
    assert st.msm_bisect_depth_max == 1
    assert st.schnorr_cpu_sigs == 12  # both halves settle on the oracle
    assert st.cpu_fallback_sigs == 0 and st.msm_fallback_sigs == 0


def test_an_all_bad_batch_is_rejected():
    recs = [_srecord(400 + i, good=False) for i in range(16)]
    got = _msm(recs)
    assert not got.any()
    assert E.STATS.msm_batches_rejected == 1
    assert E.STATS.msm_batches_accepted == 0


def test_a_precheck_only_batch_costs_no_dispatch():
    bad = SigCheckRecord(_srecord(0).pubkey, 0, 0, 1, algo="schnorr")
    got = _msm([bad] * 9)
    assert not got.any()
    assert E.STATS.msm_dispatches == 0 and E.STATS.schnorr_cpu_sigs == 0
    assert T.LAUNCHES["msm"] == 0


def test_a_mixed_batch_merges_in_submission_order(monkeypatch):
    """ECDSA lanes under msm take the GLV device split; the Schnorr lanes
    the MSM; verdicts re-merge in submission order."""
    def erec(i, good=True):
        d = 0x4444 + i
        e = int.from_bytes(hashlib.sha256(b"mx%d" % i).digest(), "big") % N
        r, s = oracle.ecdsa_sign(d, e)
        return SigCheckRecord(oracle.point_mul(d, G), r, s,
                              e if good else (e + 1) % N)

    batch = [erec(0), _srecord(500), erec(1, good=False),
             _srecord(501, good=False), erec(2)] + [
        _srecord(502 + i) for i in range(8)]
    handle = E.dispatch_batch(batch, backend="device", kernel="msm")
    assert isinstance(handle, E._MergedHandle)
    got = handle.result()
    assert got.tolist() == [True, True, False, False, True] + [True] * 8
    st = E.STATS
    assert st.glv_dev_dispatches == 1 and st.msm_dispatches >= 3
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0


def test_fail_always_at_ecdsa_msm_sends_the_batch_to_the_oracle(
        monkeypatch):
    arm(monkeypatch, "fail-always", E.MSM_SITE)
    recs = [_srecord(700 + i) for i in range(8)] + [_srecord(710, False)]
    got = _msm(recs)
    assert got.tolist() == [True] * 8 + [False]
    st = E.STATS
    assert st.msm_fallback_sigs == 9 and st.fault_fallback_sigs == 9
    assert st.msm_dispatches == 0 and T.LAUNCHES["msm"] == 0
    assert faults.INJECTOR.injected.get(E.MSM_SITE, 0) > 0


def test_poison_output_trips_the_canary(monkeypatch):
    arm(monkeypatch, "poison-output", E.MSM_SITE)
    recs = [_srecord(800 + i) for i in range(8)] + [_srecord(810, False)]
    got = _msm(recs)
    assert got.tolist() == [True] * 8 + [False]
    st = E.STATS
    assert st.msm_canary_failures >= 1 and st.kat_failures >= 1
    assert st.msm_fallback_sigs == 9 and st.msm_batches_accepted == 0


@pytest.mark.parametrize("fault", ["raises", "lies"])
def test_a_failure_nobody_injected_raises(monkeypatch, fault):
    """A kernel entry that fails, or whose verdicts are wrong (the canary
    trips) with no fault injected, raises KernelUnavailable; the oracle
    serves nothing in its place."""
    def broken(*_a):
        raise RuntimeError("launch failed: too many resources requested")

    def liar(*_a):
        return np.array([1], np.uint32)

    monkeypatch.setattr(T, "schnorr_msm_is_infinity",
                        broken if fault == "raises" else liar)
    recs = [_srecord(900 + i) for i in range(9)]
    with pytest.raises(T.KernelUnavailable):
        _msm(recs)
    st = E.STATS
    assert st.schnorr_cpu_sigs == 0 and st.msm_fallback_sigs == 0
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0


def test_an_open_breaker_with_no_fault_armed_raises():
    br = tdispatch.breaker("ecdsa")
    while br.allow():
        br.record_failure(RuntimeError("x"))
    with pytest.raises(T.KernelUnavailable):
        _msm([_srecord(950 + i) for i in range(9)])
    assert E.STATS.schnorr_cpu_sigs == 0


def test_cuda_without_a_card_raises_and_is_not_served_by_the_oracle():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    E.set_device("cuda")
    recs = [_srecord(960 + i) for i in range(9)]
    with pytest.raises(T.KernelUnavailable):
        _msm(recs)
    st = E.STATS
    assert st.schnorr_cpu_sigs == 0 and st.msm_fallback_sigs == 0
    assert st.cpu_fallback_sigs == 0
