"""A CPU model of the GLV kernels' pair design (the team codes 16 + L of
csrc/glv_verify.cu of bitcoincashplus_tpu_torch, on csrc/secp256k1_pair.cuh):
each field multiply spread over the two threads of a pair, the team of L
pairs splitting a level's products, and whole GLV lanes.

- ``PairField`` is the split multiply word by word: each thread of the pair
  runs mul_rows4 (four rows of mul512, on the PTX carry-chain model
  ``Ptx`` of tests/test_torch_w4_design.py) on its half of b's words, the
  pair swaps the 12-word halves, and each thread adds them and reduces
  (``Field.reduce512``). Where the kernel's comments argue that a chain
  cannot carry out, the model asserts it. Held against Python ints and
  against fe_mul's words on the edge operands (chip_smoke.FIELD_EDGES,
  which the card's glv_field_chain runs too) and random operands in the
  lazy range [0, 2^256).
- ``run_level_pairs`` is level<L, N> for a pair team: rounds of up to 2L
  products, a round of at most L split over pairs (pair l computing
  product min(l, n - 1)), a longer one a product a thread, each thread
  with its own registers, every thread receiving each result once. The
  pair team's point formulas (the JAX ones, with their linear steps
  regrouped and small multiples by fe_small) are read from the header
  and held against the textbook formulas, the degen flag included.
- ``glv_lane`` mirrors the kernel's glv_lane for a pair team: the T1 table,
  32 windows over the Q and lambda Q streams, 16 comb teeth over G and
  lambda G, the final check; held against the port's plain GLV verify
  (itself held equal to the JAX programs lane for lane by
  tests/test_torch_glv.py) on the GLV-degenerate lanes crafted there.

No JAX program is compiled: this is Python integer arithmetic.
"""

import functools
import importlib.util
import os
import random
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as T
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

P, N = oracle.P, oracle.N
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(REPO, "bitcoincashplus_tpu_torch", "csrc",
                    "secp256k1_pair.cuh")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the carry-chain core's model (Ptx, Field, IntField, the formula reader)
W4 = _load("w4_design_model", os.path.join(REPO, "tests",
                                           "test_torch_w4_design.py"))
CS = W4.CS
words, value = W4.words, W4.value


# ---- the split multiply, word by word ----------------------------------------

class PairField(W4.Field):
    """The carry-chain core with the pair's split multiply: ``mul_pair``
    runs both threads of a pair and returns their (equal) words."""

    # mirrors mul_rows4
    def mul_rows4(self, a, b):
        x = self.x
        ev, od = [0] * 12, [0] * 12
        for i in range(4):
            ev[i] = x.mad_lo_cc(a[0], b[i], ev[i])
            ev[i + 1] = x.madc_hi_cc(a[0], b[i], ev[i + 1])
            for j in range(2, 8, 2):
                ev[i + j] = x.madc_lo_cc(a[j], b[i], ev[i + j])
                ev[i + j + 1] = x.madc_hi_cc(a[j], b[i], ev[i + j + 1])
            ev[i + 8] = x.addc(0, 0)
            od[i + 1] = x.mad_lo_cc(a[1], b[i], od[i + 1])
            od[i + 2] = x.madc_hi_cc(a[1], b[i], od[i + 2])
            for j in range(3, 8, 2):
                od[i + j] = x.madc_lo_cc(a[j], b[i], od[i + j])
                od[i + j + 1] = x.madc_hi_cc(a[j], b[i], od[i + j + 1])
            if i + 9 < 12:
                od[i + 9] = x.addc(0, 0)
        assert x.cf == 0, "the last odd row carried out"
        q = [ev[0], x.add_cc(ev[1], od[1])]
        q += [x.addc_cc(ev[k], od[k]) for k in range(2, 11)]
        q.append(x.addc(ev[11], od[11]))
        assert x.dropped == 0, "a * b_half carried out of 2^384"
        return q

    # mirrors fe_mul_pair, both threads of the pair; ``rows`` records which
    # of b's words each thread multiplied by
    def mul_pair(self, a, b, rows=None):
        qs = []
        for half in (0, 1):
            bh = [b[4 * half + j] for j in range(4)]
            if rows is not None:
                rows.append([4 * half + j for j in range(4)])
            qs.append(self.mul_rows4(a, bh))
        outs = []
        for half in (0, 1):
            own, other = qs[half], qs[1 - half]   # the shuffle swaps them
            lo, hi = (other, own) if half else (own, other)
            x = self.x
            t = lo[:4] + [x.add_cc(lo[4], hi[0])]
            t += [x.addc_cc(lo[k], hi[k - 4]) for k in range(5, 12)]
            t += [x.addc_cc(hi[k - 4], 0) for k in range(12, 15)]
            t.append(x.addc(hi[11], 0))
            assert x.dropped == 0, "lo + hi 2^128 carried out of 2^512"
            outs.append(self.reduce512(t))
        assert outs[0] == outs[1], "the pair's threads differ"
        return outs[0]


    # mirrors fe_small<K>
    def small(self, a, k):
        x = self.x
        h = [(v * k) >> 32 for v in a]
        t = [x.mad_lo_cc(a[0], k, 0)]
        t += [x.madc_lo_cc(a[i], k, h[i - 1]) for i in range(1, 8)]
        t8 = x.addc(h[7], 0)
        assert x.dropped == 0 and t8 < k and t8 * W4.FOLD < 1 << 32
        r = [x.mad_lo_cc(t8, W4.FOLD, t[0]), x.addc_cc(t[1], t8)]
        r += [x.addc_cc(t[i], 0) for i in range(2, 8)]
        c = x.addc(0, 0)
        r[0] = x.mad_lo_cc(c, W4.FOLD, r[0])
        r[1] = x.addc(r[1], c)
        assert x.dropped == 0, "fe_small's second fold carried past word 1"
        return r


def check_pair(a: int, b: int):
    F = PairField()
    got = F.mul_pair(words(a), words(b))
    assert value(got) < 1 << 256 and (value(got) - a * b) % P == 0
    assert got == W4.Field().mul(words(a), words(b)), "not fe_mul's words"
    for k in (2, 3, 4, 6, 8):
        r = F.small(words(a), k)
        assert value(r) < 1 << 256 and (value(r) - k * a) % P == 0


@pytest.mark.parametrize("a", CS.FIELD_EDGES, ids=hex)
def test_pair_multiply_on_edge_operands(a):
    for b in CS.FIELD_EDGES:
        check_pair(a, b)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, (1 << 256) - 1), st.integers(0, (1 << 256) - 1))
def test_pair_multiply_property_over_the_lazy_range(a, b):
    check_pair(a, b)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from([0, W4.M32, 1, 0x80000000, 0xFFFFFC2F,
                                 0xFFFFFFFE]), min_size=16, max_size=16))
def test_pair_multiply_property_on_extreme_words(ws):
    check_pair(value(ws[:8]), value(ws[8:]))


def test_each_thread_of_a_pair_owns_each_row_once():
    """The split: thread h multiplies by b's words 4h .. 4h + 3, so the two
    threads take each of b's eight words (each row of mul512) exactly
    once, and both end with all eight words of the product."""
    rows = []
    PairField().mul_pair(words(3), words(5), rows)
    assert sorted(sum(rows, [])) == list(range(8))
    assert all(len(set(r)) == 4 for r in rows)


# ---- the pair team's schedule ------------------------------------------------

def run_level_pairs(F, L, regs, prods, log=None):
    """One level for a team of L pairs (mirrors level<L, N> of
    secp256k1_pair.cuh): rounds of up to 2L products, a round of at most
    L split over pairs, a longer one a product a thread; regs: one
    register dict per thread. log collects ("compute", round, unit,
    product) for each pair's (or thread's) product and ("receive",
    thread, product) for each delivery."""
    T = 2 * L
    for c in range(0, len(prods), T):
        chunk = prods[c:c + T]
        n = len(chunk)
        split = n <= L
        squares = all(b is None for _o, _a, b in chunk)
        results = []
        for t in range(T):
            out, a, b = chunk[min(t // 2 if split else t, n - 1)]
            x = regs[t][a]  # KeyError: an operand not ready at this level
            y = regs[t][b or a]
            if squares:
                results.append(F.sqr(x))
            elif split:
                partner = regs[t ^ 1]
                assert (partner[a], partner[b or a]) == (x, y), \
                    "the pair's operands differ"
                results.append(F.mul_pair(x, y))
            else:
                results.append(F.mul(x, y))
            unit = t // 2 if split else t
            if log is not None and unit < n and (not split or t % 2 == 0):
                log.append(("compute", c // T, unit, out))
        for t in range(T):
            for k in range(n):
                regs[t][chunk[k][0]] = results[
                    t if n == 1 else (2 * k if split else k)]
                if log is not None:
                    log.append(("receive", t, chunk[k][0]))


def pair_formula_steps(name: str) -> list:
    """The steps of one point formula of csrc/secp256k1_pair.cuh (the
    overload for PairTeam): as W4.cu_formula, plus ("small", r, a, K) for
    fe_small<K>(r, a). Any other statement fails."""
    src = open(PAIR).read()
    start = src.index(f" {name}(const PairTeam<L>& tm")
    body = src[src.index("{", start) + 1:src.index("\n}\n", start)]
    body = re.sub(r"//[^\n]*", "", body)
    steps = []
    for stmt in (" ".join(x.split()) for x in body.split(";")):
        if not stmt or stmt.startswith("u32 ") or stmt.startswith("return"):
            continue
        m = re.fullmatch(r"level\(tm, \{(.*)\}\)", stmt)
        if m:
            prods = re.findall(r"Prod\{(\w+), (\w+), (\w+)\}", m.group(1))
            assert len(prods) == m.group(1).count("Prod"), stmt
            steps.append(("level", [(o, a, None if b == "nullptr" else b)
                                    for o, a, b in prods]))
            continue
        m = re.fullmatch(r"fe_(add|sub)\((\w+), (\w+), (\w+)\)", stmt)
        if m:
            steps.append(m.groups())
            continue
        m = re.fullmatch(r"fe_small<(\d)>\((\w+), (\w+)\)", stmt)
        if m:
            steps.append(("small", m.group(2), m.group(3), int(m.group(1))))
            continue
        m = re.fullmatch(r"fe_copy\((\w+), (\w+)\)", stmt)
        if m:
            steps.append(("copy",) + m.groups())
            continue
        m = re.fullmatch(r"const bool (\w+) = fe_is_zero\((\w+)\)", stmt)
        if m:
            steps.append(("iszero",) + m.groups())
            continue
        raise AssertionError(f"{name}: unmodelled statement {stmt!r}")
    return steps


@functools.lru_cache(maxsize=None)
def pair_formula(name: str) -> tuple:
    return tuple(pair_formula_steps(name))


def run_formula_pairs(F, L, name, regs, log=None):
    """A point formula of secp256k1_pair.cuh on every thread of a team of
    L pairs; returns each thread's H == 0 flag (None for a doubling)."""
    flags = [None] * (2 * L)
    for step in pair_formula(name):
        kind = step[0]
        if kind == "level":
            run_level_pairs(F, L, regs, step[1], log)
            continue
        for t, r in enumerate(regs):
            if kind == "add":
                r[step[1]] = F.add(r[step[2]], r[step[3]])
            elif kind == "sub":
                r[step[1]] = F.sub(r[step[2]], r[step[3]])
            elif kind == "small":
                r[step[1]] = F.small(r[step[2]], step[3])
            elif kind == "copy":
                r[step[1]] = r[step[2]]
            else:
                flags[t] = F.is_zero(r[step[2]])
    return flags


def pair_call(F, L, name, *args, log=None):
    regs = [dict(zip(W4.PARAMS[name], args)) for _ in range(2 * L)]
    flags = run_formula_pairs(F, L, name, regs, log)
    outs = [(r["X"], r["Y"], r["Z"], f) for r, f in zip(regs, flags)]
    assert all(o == outs[0] for o in outs), f"{name}: team threads differ"
    return outs[0]


class IntPairField(W4.IntField):
    """Python ints mod p with the pair's interface (the fast stand-in for
    whole lanes)."""

    mul_pair = staticmethod(W4.IntField.mul)

    @staticmethod
    def small(a, k):
        return a * k % P


@pytest.mark.parametrize("L", [1, 2, 4])
def test_pair_formulas_match_the_textbook_formulas(L):
    rng = random.Random(20 + L)
    F = PairField()
    X, Y, Z = W4.rand_jac(rng)
    qx, qy = oracle.point_mul(rng.randrange(1, N), oracle.G)
    X2, Y2, Z2 = W4.rand_jac(rng)
    w = [words(v) for v in (X, Y, Z, qx, qy, X2, Y2, Z2)]
    got = pair_call(F, L, "pt_double", *w[:3])[:3]
    assert [F.val(v) for v in got] == list(W4.ref_double(X, Y, Z))
    got = pair_call(F, L, "pt_add_mixed", *w[:5])
    want = W4.ref_add(X, Y, Z, qx, qy, 1)
    assert [F.val(v) for v in got[:3]] == list(want[:3])
    assert got[3] == want[3] is False
    got = pair_call(F, L, "pt_add_full", *w[:3], *w[5:])
    want = W4.ref_add(X, Y, Z, X2, Y2, Z2)
    assert [F.val(v) for v in got[:3]] == list(want[:3])
    assert got[3] == want[3] is False


def test_pair_team_computes_each_product_once_and_delivers_it_once():
    rng = random.Random(6)
    X, Y, Z = W4.rand_jac(rng)
    X2, Y2, Z2 = W4.rand_jac(rng)
    for L in (1, 2, 4):
        for name, args in (("pt_double", (X, Y, Z)),
                           ("pt_add_mixed", (X, Y, Z, X2, Y2)),
                           ("pt_add_full", (X, Y, Z, X2, Y2, Z2))):
            log = []
            pair_call(IntPairField, L, name, *args, log=log)
            levels = [s[1] for s in pair_formula(name) if s[0] == "level"]
            prods = [o for lv in levels for o, _a, _b in lv]
            assert sorted(e[3] for e in log if e[0] == "compute") == \
                sorted(prods), (L, name)
            rounds = sum(-(-len(lv) // (2 * L)) for lv in levels)
            assert sum(e[0] == "compute" and e[2] == 0 for e in log) == \
                rounds, (L, name)
            for t in range(2 * L):
                got = [e[2] for e in log if e[0] == "receive" and e[1] == t]
                assert sorted(got) == sorted(prods), (L, name, t)


# ---- whole GLV lanes ------------------------------------------------------------

def glv_lane(F, L, u1, u2, qx, qy, r0, rn, wrap):
    """The kernel's glv_lane for a team of L pairs, from the verify scalars
    (split as the kernel splits them: u1's halves are the comb digits,
    u2's the ladder windows, u2's first sign folded into qy, ydiff the
    sign difference). Returns (ok, degen)."""
    m1a, n1a, m2a, n2a = T.glv_decompose(u1)
    m1b, n1b, m2b, n2b = T.glv_decompose(u2)
    c = F.const
    qy_ = (P - qy) % P if n1b else qy
    ydiff = n1b != n2b

    def nibbles(m):
        return [(m >> (4 * (31 - k))) & 15 for k in range(32)]

    def call(name, *args):
        return pair_call(F, L, name, *args)

    QX, QY = c(qx), c(qy_)
    tab = [None, (QX, QY, c(1)), call("pt_double", QX, QY, c(1))[:3]]
    for _j in range(3, 16):
        tab.append(call("pt_add_mixed", *tab[-1], QX, QY)[:3])
    beta = c(T.BETA)
    comb = T._glv_comb()

    def comb_entry(table, i, idx):
        return c(sum(int(x) << (32 * k)
                     for k, x in enumerate(comb[table, i, idx])))

    acc, inf, degen = None, True, False
    for w1, w2 in zip(nibbles(m1b), nibbles(m2b)):
        if not inf:
            for _ in range(4):
                acc = call("pt_double", *acc)[:3]
        for s, w in enumerate((w1, w2)):
            if not w:
                continue
            PX, PY, PZ = tab[w]
            if s:
                PX = F.mul_pair(beta, PX)
                if ydiff:
                    PY = F.sub(c(0), PY)
            if inf:
                acc, inf = (PX, PY, PZ), False
                continue
            *acc, hz = call("pt_add_full", *acc, PX, PY, PZ)
            degen |= hz
    for i in range(16):
        for s, (m, sg) in enumerate(((m1a, n1a), (m2a, n2a))):
            d = (m >> (8 * i)) & 255
            if not d:
                continue
            idx = sg * 256 + d
            gx, gy = comb_entry(2 if s else 0, i, idx), comb_entry(1, i, idx)
            if inf:
                acc, inf = (gx, gy, c(1)), False
                continue
            *acc, hz = call("pt_add_mixed", *acc, gx, gy)
            degen |= hz
    if inf:
        return False, degen
    ZZ = F.sqr(acc[2])
    ok = F.eq(acc[0], F.mul_pair(c(r0), ZZ)) or (
        wrap and F.eq(acc[0], F.mul_pair(c(rn), ZZ)))
    return ok, degen


def crafted_glv_lanes() -> list:
    """The GLV-degenerate lanes of tests/test_torch_glv.py and
    chip_smoke.glv_records, as records: Q = G with u1 = u2 = 5 (the ladder
    leaves 5G, the comb's first digit adds 5G), and Q = G with u1 = a + d
    256^j, u2 = d 256^j - a (tooth j adds d 256^j G to itself) for j = 0,
    3, 9; then an ordinary valid lane and its corrupt twin."""
    rng = random.Random(77)
    pairs = [(5, 5)]
    for j in (0, 3, 9):
        a = rng.randrange(256 ** j)
        top = rng.randrange(1, 256) * 256 ** j
        pairs.append((a + top, top - a))
    out = []
    for u1, u2 in pairs:
        r = oracle.point_mul(u1 + u2, oracle.G)[0] % N
        s = r * pow(u2, N - 2, N) % N
        out.append(SigCheckRecord(oracle.G, r, s, u1 * s % N))
    d, e = rng.randrange(1, N), rng.randrange(N)
    r, s = oracle.ecdsa_sign(d, e)
    pub = oracle.point_mul(d, oracle.G)
    return out + [SigCheckRecord(pub, r, s, e),
                  SigCheckRecord(pub, r, s, (e + 1) % N)]


def lane_args(rec):
    """(u1, u2, qx, qy, r0, rn, wrap) of a record, as the packers form
    them."""
    w = pow(rec.s, N - 2, N)
    wrap = rec.r + N < P
    return (rec.msg_hash * w % N, rec.r * w % N, rec.pubkey[0],
            rec.pubkey[1], rec.r, rec.r + N if wrap else rec.r, wrap)


@pytest.fixture(scope="module")
def plain_on_crafted():
    recs = crafted_glv_lanes()
    arrays = E.pack_records_w4_bytes(recs, len(recs))
    ok, degen = T.glv_dev_verify_plain(*[torch.from_numpy(
        np.ascontiguousarray(a)) for a in arrays])
    return recs, ok.tolist(), degen.tolist()


@pytest.mark.parametrize("L", [1, 4])
def test_model_lane_flags_the_crafted_glv_lanes_as_the_jax_schedule(
        L, plain_on_crafted):
    """Every crafted lane on Python ints, and one degenerate and one
    ordinary lane on the word model, flag degen and verify exactly as the
    plain verify (the JAX schedule) does."""
    recs, ok_p, dg_p = plain_on_crafted
    assert dg_p == [True] * 4 + [False, False] and ok_p[4:] == [True, False]
    for i, rec in enumerate(recs):
        assert glv_lane(IntPairField, L, *lane_args(rec)) == \
            (ok_p[i], dg_p[i]), (L, i)
    for i in (1 if L == 1 else 2, 4):
        assert glv_lane(PairField(), L, *lane_args(recs[i])) == \
            (ok_p[i], dg_p[i]), (L, i)


def test_glv_launch_table_gives_every_bucket_a_shape_the_kernel_takes():
    """ops/secp256k1.GLV_LAUNCH against csrc/glv_verify.cu's entries: a team
    code of GLV_TEAMS (1, 2, 4: glv_verify.cu's carry-chain design; 16 + L:
    glv_pair.cu's L pairs), both verify entries of that file taking it, a
    block a multiple of 32 up to 128, and
    the block's lane slots (T1 as 15 x 24 words and the split, 16 words)
    within a block's 227 KB; ECDSA_LAUNCH stays w4's."""
    csrc = os.path.join(REPO, "bitcoincashplus_tpu_torch", "csrc")
    entries = {name: open(os.path.join(csrc, name)).read()
               for name in ("glv_verify.cu", "glv_pair.cu")}
    for code in T.GLV_TEAMS:
        src, case = (entries["glv_verify.cu"], f"case {code}: return") \
            if code < T.GLV_PAIR else \
            (entries["glv_pair.cu"], f"case {code - T.GLV_PAIR}: return")
        for entry in ("DEV", "HOST"):  # the device-split and host-split
            assert src.count(f"{case} {entry}(") == 1, (code, entry)
    buckets = {E._bucket_for(n, pallas=p)
               for n in (1, 33, 129, 1000, 2000, 3000, 5000, 9000, 17000,
                         40000) for p in (False, True)}
    for B in sorted(buckets | {8190, T.GLV_SPLIT}):
        team, block = T.launch_shape(B, T.GLV_LAUNCH)
        assert team in T.GLV_TEAMS and block % 32 == 0 and block <= 128, B
        assert 4 * (15 * 24 + 16) * (block // T.team_threads(team)) \
            <= 232448, B
    assert [T.team_threads(t) for t in T.GLV_TEAMS] == [1, 2, 4, 2, 8]
    assert T.launch_shape(2048) == (4, 128)  # w4's table is its own
