"""A CPU model of the w4 ECDSA kernel's design (csrc/w4_verify.cu of
bitcoincashplus_tpu_torch, with its field core and point formulas in
csrc/secp256k1_core.cuh): its field core word by word, and its team
schedule — which team thread computes which field product at which step.

- ``Ptx`` is the PTX carry-chain instructions the kernel's field core is
  written in (one 32-bit result and the carry flag CC each), ``Field`` the
  core itself (mul512, sqr512, reduce512, fe_mul, fe_sqr, fe_add, fe_sub,
  fe_is_zero, fe_canon, fe_eq) instruction by instruction, in the kernel's
  order. Where the kernel's comments argue that a chain cannot carry out,
  the model asserts it. Held against Python ints on the edge operands
  (chip_smoke.FIELD_EDGES, which the card's w4_field_selftest runs too)
  and on random operands in the lazy range [0, 2^256).
- The point formulas are read from the header's source (pt_double,
  pt_add_mixed, pt_add_full: their levels of independent products and
  the linear steps between them) and run by ``run_formula`` for a team of
  T = 1, 2 or 4 threads, each with its own registers: a level runs in
  rounds of up to T products, thread t computing product min(t, n - 1),
  every thread receiving the round's results (the kernel's __shfl_sync).
  ``verify_lane`` mirrors the kernel's table build and window loop. Both
  are held against the textbook formulas on Python ints mod p (X, Y, Z
  and H == 0 exactly), and a whole verify against the oracle, the crafted
  collision of chip_smoke.signed_records (pubkey G, e = r) included.

No JAX program is compiled: everything here is Python integer arithmetic.
"""

import functools
import importlib.util
import os
import random
import re

import pytest
from hypothesis import given, settings, strategies as st

from bitcoincashplus_tpu.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as teb
from bitcoincashplus_tpu_torch.ops import secp256k1 as T

P, N = oracle.P, oracle.N
M32 = (1 << 32) - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the field core and the point formulas (shared by the w4 and GLV kernels)
CORE = os.path.join(REPO, "bitcoincashplus_tpu_torch", "csrc",
                    "secp256k1_core.cuh")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


# ---- the field core, word by word -------------------------------------------

class Ptx:
    """The PTX instructions of csrc/secp256k1_core.cuh's carry-chain primitives
    (add_cc .. madc_hi): 32-bit results, the carry flag ``cf``. An
    instruction without .cc leaves ``cf`` and records the carry it drops
    in ``dropped``."""

    def __init__(self):
        self.cf = 0
        self.dropped = 0

    def _cc(self, v):
        self.cf = v >> 32
        return v & M32

    def _nocc(self, v):
        self.dropped = v >> 32
        return v & M32

    def add_cc(self, a, b):
        return self._cc(a + b)

    def addc_cc(self, a, b):
        return self._cc(a + b + self.cf)

    def addc(self, a, b):
        return self._nocc(a + b + self.cf)

    def sub_cc(self, a, b):
        v = a - b
        self.cf = 1 if v < 0 else 0
        return v & M32

    def subc_cc(self, a, b):
        v = a - b - self.cf
        self.cf = 1 if v < 0 else 0
        return v & M32

    def subc(self, a, b):
        v = a - b - self.cf
        self.dropped = 1 if v < 0 else 0
        return v & M32

    def mad_lo_cc(self, a, b, c):
        return self._cc(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._cc(((a * b) & M32) + c + self.cf)

    def mad_hi_cc(self, a, b, c):
        return self._cc((a * b >> 32) + c)

    def madc_hi_cc(self, a, b, c):
        return self._cc((a * b >> 32) + c + self.cf)

    def madc_hi(self, a, b, c):
        return self._nocc((a * b >> 32) + c + self.cf)


FOLD = 977


def words(v):
    return [(v >> (32 * i)) & M32 for i in range(8)]


def value(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


class Field:
    """The kernel's field core; values are lists of 8 words, lazy: any
    pattern below 2^256 congruent to the field value."""

    def __init__(self):
        self.x = Ptx()

    # mirrors mul512
    def mul512(self, a, b):
        x = self.x
        ev, od = [0] * 16, [0] * 16
        for i in range(8):
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
            if i + 9 < 16:
                od[i + 9] = x.addc(0, 0)
        assert x.cf == 0, "the last odd row carried out"
        t = [0] * 16
        t[0] = ev[0]
        t[1] = x.add_cc(ev[1], od[1])
        for k in range(2, 15):
            t[k] = x.addc_cc(ev[k], od[k])
        t[15] = x.addc(ev[15], od[15])
        assert x.dropped == 0, "a * b carried out of 2^512"
        return t

    # mirrors sqr512
    def sqr512(self, a):
        x = self.x
        ev, od = [0] * 16, [0] * 16
        for i in range(7):
            je = (i + 2) & ~1
            if je <= 6:
                ev[i + je] = x.mad_lo_cc(a[je], a[i], ev[i + je])
                ev[i + je + 1] = x.madc_hi_cc(a[je], a[i], ev[i + je + 1])
                for j in range(je + 2, 7, 2):
                    ev[i + j] = x.madc_lo_cc(a[j], a[i], ev[i + j])
                    ev[i + j + 1] = x.madc_hi_cc(a[j], a[i], ev[i + j + 1])
                ev[i + 8] = x.addc(0, 0)
            jo = (i + 1) | 1
            od[i + jo] = x.mad_lo_cc(a[jo], a[i], od[i + jo])
            od[i + jo + 1] = x.madc_hi_cc(a[jo], a[i], od[i + jo + 1])
            for j in range(jo + 2, 8, 2):
                od[i + j] = x.madc_lo_cc(a[j], a[i], od[i + j])
                od[i + j + 1] = x.madc_hi_cc(a[j], a[i], od[i + j + 1])
            od[i + 9] = x.addc(0, 0)
        assert ev[0] == ev[1] == 0 and od[0] == 0
        xs = [0] * 16
        xs[1] = od[1]
        xs[2] = x.add_cc(ev[2], od[2])
        for k in range(3, 15):
            xs[k] = x.addc_cc(ev[k], od[k])
        xs[15] = x.addc(ev[15], od[15])
        assert x.dropped == 0 and xs[15] >> 31 == 0, "cross sum >= 2^511"

        def funnel(lo, hi):
            return ((hi << 1) | (lo >> 31)) & M32

        t = [0] * 16
        t[0] = x.mad_lo_cc(a[0], a[0], 0)
        t[1] = x.madc_hi_cc(a[0], a[0], (xs[1] << 1) & M32)
        for i in range(1, 8):
            d0 = funnel(xs[2 * i - 1], xs[2 * i])
            d1 = funnel(xs[2 * i], xs[2 * i + 1])
            t[2 * i] = x.madc_lo_cc(a[i], a[i], d0)
            if i < 7:
                t[2 * i + 1] = x.madc_hi_cc(a[i], a[i], d1)
            else:
                t[2 * i + 1] = x.madc_hi(a[i], a[i], d1)
        assert x.dropped == 0, "a^2 carried out of 2^512"
        return t

    # mirrors reduce512
    def reduce512(self, t):
        x = self.x
        r = [0] * 8
        r[0] = x.mad_lo_cc(t[8], FOLD, t[0])
        for i in range(1, 8):
            r[i] = x.madc_lo_cc(t[8 + i], FOLD, t[i])
        r8 = x.addc(0, 0)
        s = [0] * 9
        s[1] = x.mad_hi_cc(t[8], FOLD, t[8])
        for i in range(2, 9):
            s[i] = x.madc_hi_cc(t[7 + i], FOLD, t[7 + i])
        s9 = x.addc(0, 0)
        r[1] = x.add_cc(r[1], s[1])
        for i in range(2, 8):
            r[i] = x.addc_cc(r[i], s[i])
        r8 = x.addc_cc(r8, s[8])
        r9 = x.addc(s9, 0)
        assert r9 <= 1 and (r9 == 0 or r8 <= FOLD), "fold 1 bound"
        m0 = (r8 * FOLD) & M32
        k1 = (r9 * FOLD + r8) & M32
        assert k1 == r9 * FOLD + r8, "k1 overflowed"
        m1 = x.mad_hi_cc(r8, FOLD, k1)
        m2 = x.addc(r9, 0)
        r[0] = x.add_cc(r[0], m0)
        r[1] = x.addc_cc(r[1], m1)
        r[2] = x.addc_cc(r[2], m2)
        for i in range(3, 8):
            r[i] = x.addc_cc(r[i], 0)
        c2 = x.addc(0, 0)
        r[0] = x.mad_lo_cc(c2, FOLD, r[0])
        r[1] = x.addc_cc(r[1], c2)
        r[2] = x.addc(r[2], 0)
        assert x.dropped == 0, "fold 3 carried past word 2"
        return r

    def mul(self, a, b):
        return self.reduce512(self.mul512(a, b))

    def sqr(self, a):
        return self.reduce512(self.sqr512(a))

    # mirrors fe_add
    def add(self, a, b):
        x = self.x
        r = [0] * 8
        r[0] = x.add_cc(a[0], b[0])
        for i in range(1, 8):
            r[i] = x.addc_cc(a[i], b[i])
        c = x.addc(0, 0)
        r[0] = x.mad_lo_cc(c, FOLD, r[0])
        r[1] = x.addc_cc(r[1], c)
        for i in range(2, 8):
            r[i] = x.addc_cc(r[i], 0)
        c = x.addc(0, 0)
        r[0] = x.mad_lo_cc(c, FOLD, r[0])
        r[1] = x.addc(r[1], c)
        assert x.dropped == 0, "fe_add's second fold carried past word 1"
        return r

    # mirrors fe_sub
    def sub(self, a, b):
        x = self.x
        r = [0] * 8
        r[0] = x.sub_cc(a[0], b[0])
        for i in range(1, 8):
            r[i] = x.subc_cc(a[i], b[i])
        bw = x.subc(0, 0)
        r[0] = x.sub_cc(r[0], bw & FOLD)
        r[1] = x.subc_cc(r[1], bw & 1)
        for i in range(2, 8):
            r[i] = x.subc_cc(r[i], 0)
        bw = x.subc(0, 0)
        r[0] = x.sub_cc(r[0], bw & FOLD)
        r[1] = x.subc(r[1], bw & 1)
        assert x.dropped == 0, "fe_sub's second fold borrowed past word 1"
        return r

    # mirrors fe_is_zero
    @staticmethod
    def is_zero(a):
        z = 0
        np_ = (a[0] ^ 0xFFFFFC2F) | (a[1] ^ 0xFFFFFFFE)
        for i in range(8):
            z |= a[i]
        for i in range(2, 8):
            np_ |= ~a[i] & M32
        return z == 0 or np_ == 0

    # mirrors fe_canon
    def canon(self, a):
        x = self.x
        s = [0] * 8
        s[0] = x.add_cc(a[0], FOLD)
        s[1] = x.addc_cc(a[1], 1)
        for i in range(2, 8):
            s[i] = x.addc_cc(a[i], 0)
        return s if x.addc(0, 0) else list(a)

    # mirrors fe_eq
    def eq(self, a, b):
        return self.canon(a) == self.canon(b)

    @staticmethod
    def const(v):
        return words(v)

    @staticmethod
    def val(a):
        return value(a) % P


class IntField:
    """Python ints mod p with the Field interface: the fast stand-in for
    whole verifies."""

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def sqr(a):
        return a * a % P

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def is_zero(a):
        return a % P == 0

    @staticmethod
    def eq(a, b):
        return (a - b) % P == 0

    @staticmethod
    def const(v):
        return v % P

    @staticmethod
    def val(a):
        return a % P


def check_field_ops(a, b):
    F = Field()
    wa, wb = words(a), words(b)
    for name, got, want in (
            ("mul", F.mul(wa, wb), a * b),
            ("sqr", F.sqr(wa), a * a),
            ("add", F.add(wa, wb), a + b),
            ("sub", F.sub(wa, wb), a - b)):
        v = value(got)
        assert 0 <= v < 1 << 256, (name, hex(a), hex(b))
        assert (v - want) % P == 0, (name, hex(a), hex(b))
    assert value(F.mul512(wa, wb)) == a * b
    assert value(F.sqr512(wa)) == a * a
    assert value(F.canon(wa)) == a % P
    assert F.is_zero(wa) == (a % P == 0)
    assert F.eq(wa, wb) == ((a - b) % P == 0)


def test_edge_operands_cover_the_lazy_range_limits():
    edges = CS.FIELD_EDGES
    for v in (0, 1, P - 1, P, P + 1, (1 << 256) - 1,
              (1 << 256) - (1 << 32) - 978):
        assert v in edges
    assert all(0 <= v < 1 << 256 for v in edges)


@pytest.mark.parametrize("a", CS.FIELD_EDGES, ids=hex)
def test_field_core_on_edge_operands(a):
    for b in CS.FIELD_EDGES:
        check_field_ops(a, b)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, (1 << 256) - 1), st.integers(0, (1 << 256) - 1))
def test_field_core_property_over_the_lazy_range(a, b):
    check_field_ops(a, b)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from([0, M32, 1, 0x80000000, 0xFFFFFC2F,
                                 0xFFFFFFFE]), min_size=16, max_size=16))
def test_field_core_property_on_extreme_words(ws):
    """Operands made of extreme words (all ones, zero, p's low words)
    push every carry chain to its limits."""
    check_field_ops(value(ws[:8]), value(ws[8:]))


def test_square_is_bitwise_the_multiply_of_a_by_itself():
    """A team round that mixes squares and multiplies computes a square as
    fe_mul(a, a): that must be the very same words as fe_sqr(a)."""
    rng = random.Random(4)
    F = Field()
    for v in CS.FIELD_EDGES + [rng.getrandbits(256) for _ in range(200)]:
        assert F.sqr(words(v)) == F.mul(words(v), words(v)), hex(v)


# ---- the team schedule ---------------------------------------------------------

def cu_formula(name: str) -> list:
    """The steps of one point formula in csrc/secp256k1_core.cuh: ("level",
    [(out, a, b or None), ...]), ("add" | "sub", r, a, b), ("copy", r, a),
    ("iszero", flag, a). Any other statement in the body fails."""
    src = open(CORE).read()
    start = src.index(f" {name}(const TM& tm")
    body = src[src.index("{", start) + 1:src.index("\n}\n", start)]
    body = re.sub(r"//[^\n]*", "", body)
    steps = []
    for stmt in (" ".join(s.split()) for s in body.split(";")):
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
def formula(name: str) -> tuple:
    """cu_formula, read once a run (and inside a test, so that a .cu the
    parser cannot read fails that test, not the collection)."""
    return tuple(cu_formula(name))


# the kernel's argument names of each formula, in order
PARAMS = {"pt_double": ("X", "Y", "Z"),
          "pt_add_mixed": ("X", "Y", "Z", "qx", "qy"),
          "pt_add_full": ("X", "Y", "Z", "X2", "Y2", "Z2")}


def run_level(F, T, regs, prods, log=None):
    """One level for a team of T threads (mirrors level<T, N>); regs: one
    register dict per thread. log, if given, collects (round, thread,
    product) assignments."""
    if T == 1:
        r = regs[0]
        for out, a, b in prods:
            r[out] = F.mul(r[a], r[b]) if b else F.sqr(r[a])
        return
    for c in range(0, len(prods), T):
        chunk = prods[c:c + T]
        n = len(chunk)
        squares = all(b is None for _o, _a, b in chunk)
        results = []
        for t in range(T):
            out, a, b = chunk[min(t, n - 1)]
            x = regs[t][a]  # KeyError: an operand not ready at this level
            y = regs[t][b or a]
            results.append(F.sqr(x) if squares else F.mul(x, y))
            if log is not None:
                log.append((c // T, t, out))
        for t in range(T):
            for k in range(n):
                regs[t][chunk[k][0]] = results[t if n == 1 else k]


def run_formula(F, T, name, regs, log=None):
    """A point formula (as read from the .cu) on every team thread's
    registers; returns each thread's H == 0 flag (None for a doubling)."""
    flags = [None] * T
    for step in formula(name):
        kind = step[0]
        if kind == "level":
            run_level(F, T, regs, step[1], log)
            continue
        for t, r in enumerate(regs):
            if kind == "add":
                r[step[1]] = F.add(r[step[2]], r[step[3]])
            elif kind == "sub":
                r[step[1]] = F.sub(r[step[2]], r[step[3]])
            elif kind == "copy":
                r[step[1]] = list(r[step[2]]) if isinstance(
                    r[step[2]], list) else r[step[2]]
            else:
                flags[t] = F.is_zero(r[step[2]])
    return flags


def team_call(F, T, name, *args, log=None):
    """Call a formula with the same arguments in every thread; the threads
    must end with equal registers. Returns (X, Y, Z, flag)."""
    regs = [dict(zip(PARAMS[name], args)) for _ in range(T)]
    flags = run_formula(F, T, name, regs, log)
    outs = [(r["X"], r["Y"], r["Z"], f) for r, f in zip(regs, flags)]
    assert all(o == outs[0] for o in outs), f"{name}: team threads differ"
    return outs[0]


def pt_double(F, T, X, Y, Z, log=None):
    """Model of the .cu's pt_double<T> (its text, run by run_formula for a
    team of T): (X, Y, Z) doubled."""
    return team_call(F, T, "pt_double", X, Y, Z, log=log)[:3]


def pt_add_mixed(F, T, X, Y, Z, qx, qy, log=None):
    """Model of the .cu's pt_add_mixed<T>: (X, Y, Z, H == 0)."""
    return team_call(F, T, "pt_add_mixed", X, Y, Z, qx, qy, log=log)


def pt_add_full(F, T, X, Y, Z, X2, Y2, Z2, log=None):
    """Model of the .cu's pt_add_full<T>: (X, Y, Z, H == 0)."""
    return team_call(F, T, "pt_add_full", X, Y, Z, X2, Y2, Z2, log=log)


# the textbook formulas on Python ints (the JAX package's pt_double and
# cheap adds), independent of the .cu text
def ref_double(X, Y, Z):
    A, B = X * X % P, Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) ** 2 - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def ref_add(X1, Y1, Z1, X2, Y2, Z2):
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    U1, U2 = X1 * Z2Z2 % P, X2 * Z1Z1 % P
    S1, S2 = Y1 * Z2 * Z2Z2 % P, Y2 * Z1 * Z1Z1 % P
    H, R = (U2 - U1) % P, (S2 - S1) % P
    HH = H * H % P
    HHH, V = H * HH % P, U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    return X3, Y3, Z1 * Z2 * H % P, H == 0


def rand_jac(rng):
    """A random point of the curve in Jacobian form (random Z)."""
    x, y = oracle.point_mul(rng.randrange(1, N), oracle.G)
    z = rng.randrange(1, P)
    return x * z * z % P, y * z ** 3 % P, z


@pytest.mark.parametrize("T", [1, 2, 4])
def test_team_formulas_match_the_textbook_formulas(T):
    rng = random.Random(10 + T)
    F = Field()
    for _ in range(3):
        X, Y, Z = rand_jac(rng)
        qx, qy = oracle.point_mul(rng.randrange(1, N), oracle.G)
        X2, Y2, Z2 = rand_jac(rng)
        w = [words(v) for v in (X, Y, Z, qx, qy, X2, Y2, Z2)]
        got = pt_double(F, T, *w[:3])
        assert [F.val(v) for v in got] == list(ref_double(X, Y, Z))
        got = pt_add_mixed(F, T, *w[:5])
        want = ref_add(X, Y, Z, qx, qy, 1)
        assert [F.val(v) for v in got[:3]] == list(want[:3])
        assert got[3] == want[3] is False
        got = pt_add_full(F, T, *w[:3], *w[5:])
        want = ref_add(X, Y, Z, X2, Y2, Z2)
        assert [F.val(v) for v in got[:3]] == list(want[:3])
        assert got[3] == want[3] is False


def test_team_sizes_give_bitwise_equal_words():
    """Every T computes each product from the same words in the same
    order, so the lazy words themselves (not only their residues) agree."""
    rng = random.Random(3)
    F = Field()
    X, Y, Z = (words(v) for v in rand_jac(rng))
    X2, Y2, Z2 = (words(v) for v in rand_jac(rng))
    for name, args in (("pt_double", (X, Y, Z)),
                       ("pt_add_full", (X, Y, Z, X2, Y2, Z2))):
        outs = {T: team_call(F, T, name, *args) for T in (1, 2, 4)}
        assert outs[1] == outs[2] == outs[4], name


def test_team_split_assigns_each_product_once_per_round():
    """The schedule itself: rounds per formula and T, and in each round
    thread t computes product min(t, n - 1)."""
    rng = random.Random(5)
    F = IntField()
    X, Y, Z = rand_jac(rng)
    X2, Y2, Z2 = rand_jac(rng)
    rounds = {}
    for T in (1, 2, 4):
        for name, args in (("pt_double", (X, Y, Z)),
                           ("pt_add_mixed", (X, Y, Z, X2, Y2)),
                           ("pt_add_full", (X, Y, Z, X2, Y2, Z2))):
            log = []
            team_call(F, T, name, *args, log=log)
            levels = [s[1] for s in formula(name) if s[0] == "level"]
            n_prods = sum(len(p) for p in levels)
            if T == 1:
                rounds[name, T] = n_prods
                continue
            rounds[name, T] = sum(-(-len(p) // T) for p in levels)
            assert len(log) == T * rounds[name, T]
            assert {o for _r, _t, o in log} == {
                o for p in levels for o, _a, _b in p}
    # products of each formula: doubling 7, cheap mixed add 11, cheap full
    # add 16 (the bound's counts); rounds of a team of 2 and of 4
    assert [rounds["pt_double", T] for T in (1, 2, 4)] == [7, 5, 3]
    assert [rounds["pt_add_mixed", T] for T in (1, 2, 4)] == [11, 7, 5]
    assert [rounds["pt_add_full", T] for T in (1, 2, 4)] == [16, 9, 5]


def windows(u: int) -> list:
    return [(u >> (4 * (63 - k))) & 15 for k in range(64)]


def verify_lane(F, T, u1, u2, qx, qy, r0, rn, wrap, trace=None, upto=64):
    """The kernel's verify_lane for one lane and a team of T: the Q table
    (2Q by doubling, then 13 cheap mixed adds), the windows (the first
    ``upto`` of the 64), the final check. Returns (ok, degen); trace
    collects (window, kind, X, Y, Z, H == 0) after each add."""
    c = F.const
    q1 = (c(qx), c(qy), c(1))
    qtab = [None, q1, pt_double(F, T, *q1)]
    for _j in range(3, 16):
        qtab.append(pt_add_mixed(F, T, *qtab[-1], c(qx), c(qy))[:3])
    gtab = [None] + [tuple(c(v) for v in oracle.point_mul(j, oracle.G))
                     for j in range(1, 16)]
    acc, inf, degen = None, True, False
    for k, (w1, w2) in enumerate(zip(windows(u1)[:upto], windows(u2))):
        if not inf:
            for _ in range(4):
                acc = pt_double(F, T, *acc)
        for kind, w, tab in (("G", w1, gtab), ("Q", w2, qtab)):
            if not w:
                continue
            if inf:
                acc = tab[w] if kind == "Q" else (*tab[w], c(1))
                inf = False
                continue
            add = pt_add_mixed if kind == "G" else pt_add_full
            *acc, hz = add(F, T, *acc, *tab[w])
            degen |= hz
            if trace is not None:
                trace.append((k, kind, *(F.val(v) for v in acc), hz))
    regs = [{"Z": acc[2], "r0": c(r0), "rn": c(rn)} for _ in range(T)]
    run_level(F, T, regs, [("ZZ", "Z", None)])
    run_level(F, T, regs, [("t0", "r0", "ZZ"), ("t1", "rn", "ZZ")])
    ok = F.eq(acc[0], regs[0]["t0"]) or (
        wrap and F.eq(acc[0], regs[0]["t1"]))
    return ok and not inf, degen


def ref_verify(u1, u2, qx, qy, r0, rn, wrap, trace=None, upto=64):
    """The same schedule on the textbook formulas."""
    qtab = [None, (qx, qy, 1), ref_double(qx, qy, 1)]
    for _j in range(3, 16):
        qtab.append(ref_add(*qtab[-1], qx, qy, 1)[:3])
    gtab = [None] + [oracle.point_mul(j, oracle.G) for j in range(1, 16)]
    acc, inf, degen = None, True, False
    for k, (w1, w2) in enumerate(zip(windows(u1)[:upto], windows(u2))):
        if not inf:
            for _ in range(4):
                acc = ref_double(*acc)
        for kind, w in (("G", w1), ("Q", w2)):
            if not w:
                continue
            pt = (*gtab[w], 1) if kind == "G" else qtab[w]
            if inf:
                acc, inf = pt, False
                continue
            *acc, hz = ref_add(*acc, *pt)
            degen |= hz
            if trace is not None:
                trace.append((k, kind, *acc, hz))
    ZZ = acc[2] ** 2 % P
    ok = acc[0] == r0 * ZZ % P or (wrap and acc[0] == rn * ZZ % P)
    return ok and not inf, degen


def lane_inputs(pub, r, s, e):
    w = pow(s, N - 2, N)
    wrap = r + N < P
    return (e * w % N, r * w % N, pub[0], pub[1], r, r + N if wrap else r,
            wrap)


def crafted_collision(rng):
    """chip_smoke.signed_records' degenerate lane: pubkey G and e = r, so
    u1 == u2 and the first nonzero window adds jG to jG (H == 0)."""
    k = rng.randrange(1, N)
    r = oracle.point_mul(k, oracle.G)[0] % N
    s = pow(k, N - 2, N) * (2 * r) % N
    return oracle.G, r, s, r


@pytest.mark.parametrize("T", [1, 2, 4])
def test_team_verify_flags_the_crafted_collision(T):
    rng = random.Random(97)
    pub, r, s, e = crafted_collision(rng)
    assert oracle.ecdsa_verify(pub, r, s, e)
    args = lane_inputs(pub, r, s, e)
    assert args[0] == args[1]
    got_trace, ref_trace = [], []
    got = verify_lane(IntField, T, *args, trace=got_trace)
    assert got[1] is True
    assert got == ref_verify(*args, trace=ref_trace)
    assert got_trace == ref_trace
    # the collision is the full add of the first nonzero window
    first = next(t for t in got_trace if t[-1])
    assert first[1] == "Q" and first == got_trace[0]


@pytest.mark.parametrize("T", [1, 2, 4])
def test_team_verify_matches_the_oracle(T):
    rng = random.Random(40 + T)
    for i in range(4):
        d = rng.randrange(1, N)
        pub = oracle.point_mul(d, oracle.G)
        e = rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        if i % 2:
            e = (e + 1) % N
        args = lane_inputs(pub, r, s, e)
        ok, degen = verify_lane(IntField, T, *args)
        assert not degen
        assert ok == oracle.ecdsa_verify(pub, r, s, e) == (i % 2 == 0)
        assert (ok, degen) == ref_verify(*args)


def test_word_model_runs_the_collision_lane_windows():
    """The first windows of the crafted collision lane on the word-level
    field, for every team size: the same (X, Y, Z, H == 0) as the
    textbook schedule, the collision flagged at the first nonzero window.
    (Table build and two windows only: the word model is slow.)"""
    rng = random.Random(98)
    pub, r, s, e = crafted_collision(rng)
    u1, u2, qx, qy, r0, rn, wrap = lane_inputs(pub, r, s, e)
    upto = next(k for k, w in enumerate(windows(u1)) if w) + 2
    ref_trace = []
    ref_verify(u1, u2, qx, qy, r0, rn, wrap, trace=ref_trace, upto=upto)
    for T in (1, 2, 4):
        trace = []
        _ok, degen = verify_lane(Field(), T, u1, u2, qx, qy, r0, rn, wrap,
                                 trace=trace, upto=upto)
        assert degen and trace[0][-1] and trace == ref_trace, T


def test_launch_table_gives_every_bucket_a_shape_the_kernel_takes():
    """ops/secp256k1.ECDSA_LAUNCH against the C entries' rules: a team of 1,
    2 or 4, a block a multiple of 32 up to 128, and the block's shared
    memory (the G table, then 15 x 96 B a lane) within a block's 227 KB."""
    buckets = {teb._bucket_for(n, pallas=p)
               for n in (1, 33, 129, 1000, 2000, 3000, 5000, 9000, 17000,
                         40000) for p in (False, True)}
    for B in sorted(buckets | {8190}):  # 8190: dispatch_packed's slice
        team, block = T.launch_shape(B)
        assert team in (1, 2, 4) and block % 32 == 0 and block <= 128, B
        assert 4 * (16 * 16 + 15 * 24 * (block // team)) <= 232448, B
    assert T.launch_shape(2048)[0] == 4  # the main path's bucket
