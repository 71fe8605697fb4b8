"""Batch secp256k1 verification: the w4 rung, the GLV rungs, the bit
ladder and the Schnorr batch check (a Pippenger MSM).

Port of the w4, GLV, bit-ladder and MSM parts of the reference's
ops/secp256k1.py. Two layers:

- **The kernels** (CUDA C++ for sm_90a, built with nvcc at first use and
  bound with ctypes by ops/cuda_build.py; their field core and point
  formulas are ``csrc/secp256k1_core.cuh``).
  ``csrc/w4_verify.cu`` replaces both Pallas w4 kernels of the JAX
  package: ``_verify_kernel_w4_3d`` (its ``pallas_call`` at
  bitcoincashplus_tpu/ops/secp256k1.py:912, behind
  ``ecdsa_verify_batch_pallas_w4_bytes``) through the entry
  ``w4_verify_bytes``, and ``_verify_kernel_w4`` (``pallas_call`` at
  :827, behind ``ecdsa_verify_batch_pallas_w4``) through the entry
  ``w4_verify_planes``. ``csrc/glv_verify.cu`` replaces the plain-XLA GLV
  programs: ``_glv_dev_program`` (:1559, the device split and verify)
  through ``glv_dev_verify``, ``_glv_program`` (:1296, the verify from a
  host split) through ``glv_verify`` and ``_glv_decompose_program``
  (:1539) through ``glv_decompose``. Both are bound by integer
  multiply-adds (about 437,000 32-bit IMADs a w4 verify, 298,000 a GLV
  one; see the source notes): a field core of PTX carry chains, the
  per-lane tables in shared memory, and a team of T threads per lane, T
  and the block size picked per bucket by ``ECDSA_LAUNCH``. GLV has a
  second design beside that one, ``csrc/glv_pair.cu`` on
  ``csrc/secp256k1_pair.cuh`` (a team of pairs of threads; each multiply
  spread over a pair, half its rows each), with the same lane
  (``csrc/glv_lane.cuh``); ``GLV_LAUNCH`` picks the design, team and
  block per bucket. ``csrc/msm.cu`` replaces the plain-XLA MSM programs
  ``_msm_program`` (:1967) and ``_msm_partial_program`` (:1977) through
  the entry ``msm_run`` (see its section below). ``csrc/ladder_verify.cu``
  replaces the plain-XLA bit ladder ``ecdsa_verify_batch_jit`` (:508-512,
  over ``ecdsa_verify_batch_device``, :463) through the entry
  ``ladder_verify`` (see the last section).
- **The plain versions**: the same verifies in PyTorch tensor ops, used
  for tensors on the CPU (the tests) and as the yardstick the kernels are
  held against on the card. They carry field elements as (..., 16) int64
  tensors of 16-bit limbs (lanes first): torch has no usable uint32
  arithmetic on the CPU, and int64 leaves room for a whole schoolbook
  column sum. A field multiply is one broadcast limb product and one
  anti-diagonal sum, then a fold of 2^256 == 2^32 + 977 and four parallel
  carry rounds.

The wrappers keep the reference's names, argument order, shapes and
``(ok, degen)`` bool results. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises
``KernelUnavailable`` — it never falls back.

Every verify keeps the reference's schedule (w4: 64 MSB-first windows, 4
doublings, the G add before the Q add, the Q table built as in
``_w4_tables``; GLV: see its section below), so the degen plane — an
H == 0 collision between finite points in a cheap add — matches the JAX
programs lane for lane. Degen lanes carry garbage and are re-verified on
the host by the caller (ops/ecdsa_batch.BatchHandle).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.secp256k1 import G, N, P, point_add, point_double
from . import cuda_build
from .cuda_build import KernelUnavailable

LIMB_BITS = 16
N_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1

# JAX package's limb form (20 x 13-bit, limb-major) — the converters below
# carry field elements between the two packages
JAX_LIMB_BITS = 13
JAX_N_LIMBS = 20


# Launch counts per kernel entry, and per (entry, lanes) shape: each
# wrapper adds one where it launches its kernel, and nowhere else (the
# plain version does not count).
LAUNCHES = {"w4_verify_bytes": 0, "w4_verify_planes": 0,
            "glv_dev_verify": 0, "glv_verify": 0, "glv_decompose": 0,
            "msm": 0, "msm_partial": 0, "ladder_verify": 0}
LAUNCH_SHAPES: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


# ---- limb conversions -------------------------------------------------------

def to_limbs(values, device="cpu") -> torch.Tensor:
    """Python ints -> (len, 16) int64 exact 16-bit limbs (values < 2^256)."""
    rows = [[(int(v) >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]
            for v in values]
    return torch.tensor(rows, dtype=torch.int64, device=device).reshape(
        len(rows), N_LIMBS)


def from_limbs(t: torch.Tensor) -> list[int]:
    """(..., 16) limbs of any magnitude -> the represented ints (not
    reduced mod p)."""
    a = t.detach().to("cpu").reshape(-1, N_LIMBS).tolist()
    return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row))
            for row in a]


def limbs_from_jax(np_limbs13: np.ndarray, device="cpu") -> torch.Tensor:
    """The JAX package's (20, B) 13-bit limb planes (numpy, any limb
    magnitude below 2^32) -> the port's (B, 16) limb tensor of the same
    value mod p."""
    a = torch.from_numpy(np.ascontiguousarray(np_limbs13).astype(np.int64))
    return _limbs13_to_port(a.to(device))


def _limbs13_to_port(a: torch.Tensor) -> torch.Tensor:
    """(20, B) int64 13-bit limb planes -> (B, 16) weak limbs, same value
    mod p, on a's device."""
    a = a.T
    out = torch.zeros(a.shape[0], N_LIMBS + 2, dtype=torch.int64,
                      device=a.device)
    for i in range(JAX_N_LIMBS):
        k, s = divmod(JAX_LIMB_BITS * i, LIMB_BITS)
        v = a[:, i] << s
        out[:, k] += v & MASK
        out[:, k + 1] += (v >> LIMB_BITS) & MASK
        out[:, k + 2] += v >> (2 * LIMB_BITS)
    return f_carry(_fold_high(out))


def limbs_to_jax(t: torch.Tensor) -> np.ndarray:
    """The port's (B, 16) limbs -> the JAX package's (20, B) uint32 exact
    13-bit limbs of the canonical value in [0, p)."""
    vals = [v % P for v in from_limbs(t)]
    out = np.zeros((JAX_N_LIMBS, len(vals)), np.uint32)
    for j, v in enumerate(vals):
        for i in range(JAX_N_LIMBS):
            out[i, j] = (v >> (JAX_LIMB_BITS * i)) & ((1 << JAX_LIMB_BITS) - 1)
    return out


# ---- plain field arithmetic mod p = 2^256 - 2^32 - 977 ----------------------
#
# Magnitudes (all limbs non-negative):
#   "weak"  = limbs < 2^17 (f_mul / f_carry outputs);
#   f_add of weak values < 2^18; f_sub(a, b) with a weak and b < 2^21 - 32
#   gives limbs < 2^23; f_mul takes limbs < 2^23 (a 16-term column of
#   products stays < 2^50, and the fold by 977 < 2^60).


def _make_bias() -> list[int]:
    """64p redistributed so every limb is >= 2^21 - 32: a + BIAS - b is
    limbwise non-negative for any b with limbs < 2^21 - 32."""
    v = 64 * P
    limbs = [(v >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS - 1)]
    limbs.append(v >> (LIMB_BITS * (N_LIMBS - 1)))
    for i in range(N_LIMBS - 1):
        limbs[i] += 1 << 21
        limbs[i + 1] -= 1 << (21 - LIMB_BITS)
    assert min(limbs) >= (1 << 21) - 32
    assert sum(x << (LIMB_BITS * i) for i, x in enumerate(limbs)) == v
    return limbs


_BIAS = _make_bias()
_P_LIMBS = [(P >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]
_CONSTS: dict[str, dict] = {}


def _consts(device) -> dict:
    """Per-device constant tensors: the bias, p, the affine G table (row
    j = jG, row 0 unused), 1 and beta."""
    key = str(device)
    c = _CONSTS.get(key)
    if c is None:
        gx, gy = [0], [0]
        pt = G
        for _j in range(1, 16):
            gx.append(pt[0])
            gy.append(pt[1])
            pt = point_add(pt, G)
        c = {
            "bias": torch.tensor(_BIAS, dtype=torch.int64, device=device),
            "p": torch.tensor(_P_LIMBS, dtype=torch.int64, device=device),
            "gx": to_limbs(gx, device),
            "gy": to_limbs(gy, device),
            "one": to_limbs([1], device)[0],
            "beta": to_limbs([BETA], device)[0],
            # where a carry out of 2^256 lands: 977 at limb 0, 1 at limb 2
            "fold": to_limbs([(1 << 32) + 977], device)[0],
        }
        _CONSTS[key] = c
    return c


def _fold_high(v: torch.Tensor) -> torch.Tensor:
    """(..., K) limbs, K > 16 -> (..., 16): every limb at weight
    2^(256 + 16 j) folds down as 977 at limb j and 1 at limb j + 2
    (2^256 == 2^32 + 977 mod p), repeated until 16 limbs remain."""
    while v.shape[-1] > N_LIMBS:
        lo, hi = v[..., :N_LIMBS], v[..., N_LIMBS:]
        h = hi.shape[-1]
        width = max(N_LIMBS, h + 2)
        v = (F.pad(lo, (0, width - N_LIMBS))
             + F.pad(hi * 977, (0, width - h))
             + F.pad(hi, (2, width - h - 2)))
    return v


def _carry_round(v: torch.Tensor) -> torch.Tensor:
    """One parallel carry round on (..., 16) limbs; the carry out of limb
    15 folds back as 977 at limb 0 and 1 at limb 2."""
    c = v >> LIMB_BITS
    return ((v & MASK) + F.pad(c[..., :15], (1, 0))
            + c[..., 15:] * _consts(v.device)["fold"])


def f_carry(v: torch.Tensor) -> torch.Tensor:
    """Any non-negative (..., 16) limbs < 2^60 -> weak (limbs < 2^17)."""
    for _ in range(4):
        v = _carry_round(v)
    return v


def _antidiag_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., L, L) -> (..., 2L - 1): column k sums x[i, j] over i + j = k.
    Pad every row to 2L, flatten, drop the last L entries and re-read as
    rows of 2L - 1: row i is then shifted right by i."""
    L = x.shape[-1]
    lead = x.shape[:-2]
    y = F.pad(x, (0, L)).reshape(*lead, 2 * L * L)[..., : L * (2 * L - 1)]
    return y.reshape(*lead, L, 2 * L - 1).sum(dim=-2)


def f_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field product of (..., 16) limbs < 2^23 -> weak."""
    cols = _antidiag_sum(a.unsqueeze(-1) * b.unsqueeze(-2))
    return f_carry(_fold_high(cols))


def f_sqr(a: torch.Tensor) -> torch.Tensor:
    return f_mul(a, a)


def f_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def f_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + 64p, limbwise non-negative for b < 2^21 - 32."""
    return a + _consts(a.device)["bias"] - b


def f_carry_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return f_carry(f_sub(a, b))


def f_canonical(v: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs < 2^60 -> the exact 16-bit limbs of a value in
    [0, 2^256) congruent mod p (p itself stays p; see f_is_zero)."""
    v = f_carry(v)
    for _ in range(3):
        out = []
        c = torch.zeros_like(v[..., 0])
        for i in range(N_LIMBS):
            t = v[..., i] + c
            out.append(t & MASK)
            c = t >> LIMB_BITS
        v = torch.stack(out, dim=-1)
        v = v + torch.cat([(c * 977).unsqueeze(-1), torch.zeros_like(v[..., :1]),
                           c.unsqueeze(-1), torch.zeros_like(v[..., 3:])],
                          dim=-1)
    return v


def f_is_zero(v: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (...) bool: value == 0 mod p (the canonical
    pre-image is 0 or p)."""
    c = f_canonical(v)
    p = _consts(v.device)["p"]
    return (c == 0).all(dim=-1) | (c == p).all(dim=-1)


# ---- plain group arithmetic (Jacobian; points are (X, Y, Z, inf)) ----------

def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.unsqueeze(-1), a, b)


def pt_select(mask, t: tuple, f: tuple) -> tuple:
    return (_where(mask, t[0], f[0]), _where(mask, t[1], f[1]),
            _where(mask, t[2], f[2]), torch.where(mask, t[3], f[3]))


def pt_double(pt: tuple) -> tuple:
    """dbl-2009-l on y^2 = x^3 + 7 (the reference's pt_double):
    A=X^2, B=Y^2, C=B^2, D=2((X+B)^2-A-C), E=3A, F=E^2,
    X3=F-2D, Y3=E(D-X3)-8C, Z3=2YZ; infinity propagates unchanged."""
    X, Y, Z, inf = pt
    A = f_sqr(X)
    B = f_sqr(Y)
    C = f_sqr(B)
    D = f_sqr(f_add(X, B))
    D = f_carry(2 * f_sub(D, f_add(A, C)))
    E = 3 * A
    X3 = f_carry_sub(f_sqr(E), f_add(D, D))
    Y3 = f_carry_sub(f_mul(E, f_sub(D, X3)), 8 * C)
    Z3 = f_carry(2 * f_mul(Y, Z))
    return (X3, Y3, Z3, inf)


def _pt_add_mixed_cheap_u(pt: tuple, qx, qy, q_inf):
    """Mixed cheap add, no same/opposite resolution (the reference's
    _pt_add_mixed_cheap_u): returns (point, hzero) where hzero is the
    H == 0 flag between two finite points."""
    X, Y, Z, inf = pt
    Z1Z1 = f_sqr(Z)
    U2 = f_mul(qx, Z1Z1)
    S2 = f_mul(qy, f_mul(Z, Z1Z1))
    H = f_sub(U2, X)
    R = f_sub(S2, Y)
    hzero = f_is_zero(H) & ~inf & ~q_inf
    HH = f_sqr(H)
    HHH = f_mul(H, HH)
    V = f_mul(X, HH)
    X3 = f_carry_sub(f_sqr(R), f_add(HHH, f_add(V, V)))
    Y3 = f_carry_sub(f_mul(R, f_sub(V, X3)), f_mul(Y, HHH))
    Z3 = f_mul(Z, H)
    out = (X3, Y3, Z3, torch.zeros_like(inf))
    one = _consts(X.device)["one"].expand_as(X)
    q_as_jac = (qx.expand_as(X), qy.expand_as(X), one, q_inf)
    out = pt_select(inf, q_as_jac, out)
    out = pt_select(q_inf & ~inf, pt, out)
    return out, hzero


def _pt_add_full_cheap_u(pt: tuple, q: tuple):
    """Full Jacobian cheap add (the reference's _pt_add_full_cheap_u)."""
    X1, Y1, Z1, inf1 = pt
    X2, Y2, Z2, inf2 = q
    Z1Z1 = f_sqr(Z1)
    Z2Z2 = f_sqr(Z2)
    U1 = f_mul(X1, Z2Z2)
    U2 = f_mul(X2, Z1Z1)
    S1 = f_mul(Y1, f_mul(Z2, Z2Z2))
    S2 = f_mul(Y2, f_mul(Z1, Z1Z1))
    H = f_sub(U2, U1)
    R = f_sub(S2, S1)
    hzero = f_is_zero(H) & ~inf1 & ~inf2
    HH = f_sqr(H)
    HHH = f_mul(H, HH)
    V = f_mul(U1, HH)
    X3 = f_carry_sub(f_sqr(R), f_add(HHH, f_add(V, V)))
    Y3 = f_carry_sub(f_mul(R, f_sub(V, X3)), f_mul(S1, HHH))
    Z3 = f_mul(f_mul(Z1, Z2), H)
    out = (X3, Y3, Z3, torch.zeros_like(inf1))
    out = pt_select(inf1, q, out)
    out = pt_select(inf2 & ~inf1, pt, out)
    return out, hzero


def _w4_tables(qx, qy, q_inf) -> tuple:
    """The w4 core's tables. G: the constant affine jG rows (16, 16) each
    (row 0 unused). Q: jQ for j = 1..15, Jacobian, stacked as (16, B, 16)
    per coordinate plus (16, B) inf (entry 0 zero, never selected):
    2Q by doubling, then (j-1)Q + Q by the cheap mixed add — as the
    reference's _w4_tables."""
    c = _consts(qx.device)
    one = c["one"].expand_as(qx)
    q1 = (qx, qy, one, q_inf)
    tab = [None, q1, pt_double(q1)]
    for j in range(3, 16):
        added, _hz = _pt_add_mixed_cheap_u(tab[j - 1], qx, qy, q_inf)
        tab.append(added)
    zero = torch.zeros_like(qx)
    q_tab = tuple(
        torch.stack([zero] + [e[k] for e in tab[1:]]) for k in range(3)
    ) + (torch.stack([torch.zeros_like(q_inf)] + [e[3] for e in tab[1:]]),)
    return (c["gx"], c["gy"]), q_tab


def _w4_window_step(carry: tuple, w1, w2, g_tab, q_tab, q_inf) -> tuple:
    """One window: 4 doublings, then the G mixed add (w1 != 0), then the Q
    full add (w2 != 0, Q finite). w1/w2: (B,) int64 window values."""
    acc, degen = carry
    for _ in range(4):
        acc = pt_double(acc)
    added, hz = _pt_add_mixed_cheap_u(acc, g_tab[0][w1], g_tab[1][w1],
                                      torch.zeros_like(q_inf))
    act1 = w1 != 0
    acc = pt_select(act1, added, acc)
    degen = degen | (hz & act1)
    lane = torch.arange(w2.shape[0], device=w2.device)
    q_sel = tuple(t[w2, lane] for t in q_tab)
    act2 = (w2 != 0) & ~q_inf
    added, hz = _pt_add_full_cheap_u(acc, q_sel)
    acc = pt_select(act2, added, acc)
    degen = degen | (hz & act2)
    return acc, degen


def _verify_final(acc: tuple, degen, q_inf, r0, rn, wrap):
    """X == r0 Z^2, or X == rn Z^2 where wrap allows; -> (ok, degen)."""
    X, _Y, Z, inf = acc
    ZZ = f_sqr(Z)
    ok0 = f_is_zero(f_sub(X, f_mul(r0, ZZ)))
    ok1 = f_is_zero(f_sub(X, f_mul(rn, ZZ))) & wrap
    ok = ~inf & ~q_inf & (ok0 | ok1)
    return ok, degen & ~q_inf


def w4_verify_plain(u1w, u2w, qx, qy, q_inf, r0, rn, wrap):
    """The plain PyTorch w4 verify. u1w/u2w: (B, 64) int64 MSB-first
    windows; qx/qy/r0/rn: (B, 16) limbs; q_inf/wrap: (B,) bool.
    Returns (ok, degen) (B,) bool."""
    B = qx.shape[0]
    g_tab, q_tab = _w4_tables(qx, qy, q_inf)
    one = _consts(qx.device)["one"].expand_as(qx)
    acc = (one, one, torch.zeros_like(qx),
           torch.ones(B, dtype=torch.bool, device=qx.device))
    carry = (acc, torch.zeros(B, dtype=torch.bool, device=qx.device))
    for k in range(64):
        carry = _w4_window_step(carry, u1w[:, k], u2w[:, k], g_tab, q_tab,
                                q_inf)
    return _verify_final(carry[0], carry[1], q_inf, r0, rn, wrap)


# ---- byte expansions ---------------------------------------------------------

def _expand_nibble_windows(m: torch.Tensor) -> torch.Tensor:
    """(B, nb) uint8 big-endian bytes -> (2 nb, B) int64 MSB-first 4-bit
    windows (the reference's layout)."""
    hi = (m >> 4).to(torch.int64)
    lo = (m & 0xF).to(torch.int64)
    return torch.stack([hi, lo], dim=2).reshape(m.shape[0], -1).T


def _expand_limb_cols(m: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 big-endian values -> (B, 16) exact 16-bit limbs (the
    port's limb form; the value is not reduced mod p)."""
    le = m.flip(-1).to(torch.int64)  # little-endian bytes
    return le[:, 0::2] | (le[:, 1::2] << 8)


def bits_to_windows_np(scalar_bytes: np.ndarray, bucket: int) -> np.ndarray:
    """(n, 32) big-endian scalar bytes -> (64, bucket) uint32 4-bit window
    planes, MSB-first (window 0 = bits 255..252)."""
    n = scalar_bytes.shape[0]
    hi = (scalar_bytes >> 4).astype(np.uint32)
    lo = (scalar_bytes & 0xF).astype(np.uint32)
    inter = np.stack([hi, lo], axis=2).reshape(n, 64)
    out = np.zeros((64, bucket), np.uint32)
    out[:, :n] = inter.T
    return out


# ---- the CUDA kernel: launch ------------------------------------------------

_ENTRY_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# The launch shape per bucket of the w4 verify entries: (most lanes, team
# size T, threads a block); the first row whose lane count covers B
# applies. T threads of a team verify one lane (1, 2 or 4; see
# csrc/w4_verify.cu). Chosen from chip_smoke.py's timing of every
# compared shape at each T and block size on the H100 (PERF.md, K4, K5).
ECDSA_LAUNCH = ((2048, 4, 128), (8192, 2, 64), (None, 1, 128))

# The GLV verify launches' team codes: 1, 2 or 4 is the carry-chain
# design's team of T threads a lane (csrc/glv_verify.cu's entries),
# GLV_PAIR + L (L = 1 or 4) the pair design's team of L pairs, 2L threads
# a lane (csrc/glv_pair.cu's entries, named with _pair).
GLV_PAIR = 16
GLV_TEAMS = (1, 2, 4, GLV_PAIR + 1, GLV_PAIR + 4)
# The launch shape per bucket of glv_dev_verify and glv_verify, as
# ECDSA_LAUNCH: (most lanes, team code, threads a block). Chosen from
# chip_smoke.py's timing of both entries at every compared shape, team
# code and block size on the H100 (PERF.md, K6, K7): the fastest whose
# results were equal to the plain version's on every compare.
GLV_LAUNCH = ((2048, GLV_PAIR + 4, 128), (8192, GLV_PAIR + 1, 64),
              (None, 1, 128))


def launch_shape(B: int, table: tuple = ECDSA_LAUNCH) -> tuple:
    """(team, threads a block) of a verify launch of B lanes."""
    return next((team, block) for most, team, block in table
                if most is None or B <= most)


def team_threads(team: int) -> int:
    """Threads a lane of a GLV team code."""
    return 2 * (team - GLV_PAIR) if team > GLV_PAIR else team


def verify_plan(name: str, inputs: list, out: torch.Tensor,
                team: int | None = None, block: int | None = None):
    """A prepared launch of the verify entry ``name`` (w4_verify_bytes,
    w4_verify_planes, glv_dev_verify, glv_verify): ``inputs`` contiguous
    CUDA tensors of B lanes in the entry's order, ``out`` a (2, B) uint8
    tensor on their card that the kernel writes (ok, degen) to. The typed
    entry, the pointers and the launch shape (team and block default to
    ECDSA_LAUNCH's or GLV_LAUNCH's; a GLV entry takes one launch a
    GLV_SPLIT lanes) are fixed here. Returns ``launch(stream)``, which
    launches on the CUDA stream handle ``stream`` and counts each launch:
    a caller that keeps its buffers (parallel/sig_shard) pays the launch
    alone. The launch holds the tensors whose pointers it took."""
    B = out.shape[1]
    glv = name.startswith("glv")
    calls = []
    for s in range(0, B, GLV_SPLIT if glv else max(B, 1)):
        n = min(GLV_SPLIT, B - s) if glv else B
        t, b = (team, block) if team is not None else launch_shape(
            n, GLV_LAUNCH if glv else ECDSA_LAUNCH)
        ptrs = [x[s:].data_ptr() for x in inputs]
        if glv:
            entry, code = (name + "_pair", t - GLV_PAIR) if t > GLV_PAIR \
                else (name, t)
            ptrs.append(_comb_on(out.device, "words").data_ptr())
            argtypes = [ctypes.c_void_p] * (len(inputs) + 3) \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            entry, code, argtypes = name, t, _ENTRY_ARGS
        calls.append((cuda_build.entry(entry, argtypes), entry, n,
                      (*ptrs, out[0, s:].data_ptr(), out[1, s:].data_ptr(),
                       n, code, b)))

    def launch(stream: int, _keep=(inputs, out)) -> None:
        for fn, entry, n, args in calls:
            cuda_build.check_launch(entry, fn(*args, stream))
            LAUNCHES[name] += 1
            LAUNCH_SHAPES[(name, n)] = LAUNCH_SHAPES.get((name, n), 0) + 1
    return launch


def _launch(name: str, inputs: list, B: int, team: int | None = None,
            block: int | None = None) -> torch.Tensor:
    """Launch the verify entry ``name`` on the current stream (verify_plan:
    a GLV entry once a GLV_SPLIT lanes): inputs are contiguous CUDA
    tensors; allocates and returns the (2, B) uint8 (ok, degen) rows.
    team and block default to the entry's launch table."""
    dev = inputs[0].device
    out = torch.empty(2, B, dtype=torch.uint8, device=dev)
    verify_plan(name, inputs, out, team, block)(
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def _check(tensors: list, device, shapes: list, dtypes: tuple) -> None:
    for t, shape in zip(tensors, shapes):
        if t.device != device:
            raise ValueError(f"inputs on mixed devices: {t.device} vs {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"dtype {t.dtype}, expected one of {dtypes}")


def ecdsa_verify_batch_pallas_w4_bytes(u1m, u2m, qxb, qyb, q_inf8, r0b, rnb,
                                       wrap8):
    """Byte-matrix w4 verify: (B, 32) uint8 big-endian scalars, pubkey
    coordinates and r candidates, (B,) uint8 q_inf / wrap masks, B a
    multiple of 1024. Returns (ok, degen) (B,) bool on the inputs' device
    (CUDA results are still in flight until read). One launch covers the
    whole batch (the reference split at 16384 lanes per compiled program;
    a CUDA launch has no compiled shape to bound)."""
    B = qxb.shape[0]
    if B % 1024:
        raise ValueError(f"B={B} is not a multiple of 1024")
    dev = qxb.device
    mats = [u1m, u2m, qxb, qyb, r0b, rnb]
    _check(mats, dev, [(B, 32)] * 6, (torch.uint8,))
    _check([q_inf8, wrap8], dev, [(B,)] * 2, (torch.uint8, torch.bool))
    if dev.type == "cpu":
        return w4_verify_bytes_plain(u1m, u2m, qxb, qyb, q_inf8, r0b, rnb,
                                     wrap8)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no w4 kernel for device {dev}")
    u8 = [t.contiguous() for t in (u1m, u2m, qxb, qyb)] + [
        q_inf8.to(torch.uint8).contiguous(), r0b.contiguous(),
        rnb.contiguous(), wrap8.to(torch.uint8).contiguous()]
    ok, degen = _launch("w4_verify_bytes", u8, B)
    return ok.view(torch.bool), degen.view(torch.bool)


def ecdsa_verify_batch_pallas_w4(u1w, u2w, qx, qy, q_inf, r0, rn, wrap_ok):
    """Plane w4 verify: (64, B) MSB-first window planes, (20, B) 13-bit
    limb planes (the reference's host expansion; int32 or uint32), (B,)
    bool/uint8 q_inf and wrap masks. Returns (ok, degen) (B,) bool; degen
    lanes MUST be re-verified on the host."""
    B = qx.shape[1]
    dev = qx.device
    _check([u1w, u2w], dev, [(64, B)] * 2, (torch.int32, torch.uint32))
    _check([qx, qy, r0, rn], dev, [(JAX_N_LIMBS, B)] * 4,
           (torch.int32, torch.uint32))
    _check([q_inf, wrap_ok], dev, [(B,)] * 2, (torch.uint8, torch.bool))
    if dev.type == "cpu":
        return w4_verify_planes_plain(u1w, u2w, qx, qy, q_inf, r0, rn,
                                      wrap_ok)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no w4 kernel for device {dev}")
    inputs = [u1w.contiguous(), u2w.contiguous(), qx.contiguous(),
              qy.contiguous(), q_inf.to(torch.uint8).contiguous(),
              r0.contiguous(), rn.contiguous(),
              wrap_ok.to(torch.uint8).contiguous()]
    ok, degen = _launch("w4_verify_planes", inputs, B)
    return ok.view(torch.bool), degen.view(torch.bool)


def w4_verify_bytes_plain(u1m, u2m, qxb, qyb, q_inf8, r0b, rnb, wrap8):
    """The plain version of ecdsa_verify_batch_pallas_w4_bytes, on the
    inputs' own device (the CPU in the tests; the card in chip_smoke.py,
    where the kernel is held against it); live lanes only."""
    return _on_live_lanes(_w4_bytes_live, q_inf8, u1m, u2m, qxb, qyb,
                          q_inf8, r0b, rnb, wrap8)


def _w4_bytes_live(u1m, u2m, qxb, qyb, q_inf8, r0b, rnb, wrap8):
    return w4_verify_plain(
        _expand_nibble_windows(u1m).T, _expand_nibble_windows(u2m).T,
        _expand_limb_cols(qxb), _expand_limb_cols(qyb), q_inf8 != 0,
        _expand_limb_cols(r0b), _expand_limb_cols(rnb), wrap8 != 0)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 or uint32 words -> their unsigned values as int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _lim13(t: torch.Tensor) -> torch.Tensor:
    """(20, B) 13-bit limb planes (int32 or uint32) -> (B, 16) limbs."""
    return _limbs13_to_port(_u32(t))


def w4_verify_planes_plain(u1w, u2w, qx, qy, q_inf, r0, rn, wrap_ok):
    """The plain version of ecdsa_verify_batch_pallas_w4, on the inputs'
    own device."""
    return w4_verify_plain(_u32(u1w).T & 0xF, _u32(u2w).T & 0xF, _lim13(qx),
                           _lim13(qy), q_inf != 0, _lim13(r0), _lim13(rn),
                           wrap_ok != 0)


# ---- GLV: the endomorphism split verify (K6, K7) ----------------------------
#
# Port of the GLV part of the reference's ops/secp256k1.py. secp256k1 has an
# efficient endomorphism phi(x, y) = (beta x, y) = lambda (x, y), so every
# 256-bit scalar splits as k = k1 + lambda k2 (mod n) with |k1|, |k2| below
# 2^128:
#
#   u1 G + u2 Q = s11 (+-G) + s12 (+-lambda G) + s21 (+-Q) + s22 (+-lambda Q)
#
# The Q streams run a 32-window ladder (4 doublings, then a cheap full add
# from the Q table and one from the lambda Q table, which is the Q table
# with X -> beta X and Y negated where the two Q-stream signs differ); the
# G streams are a fixed-base comb of d 256^i G (16 teeth of 8-bit digits),
# added after the ladder by cheap mixed adds. u1's halves are the comb
# digits, u2's the ladder windows; the first Q-stream sign is folded into
# qy. The schedule is the reference's, so the degen plane matches it lane
# for lane.
#
# Three layers, as for w4:
# - the host part: the constants, the Python-int split (the oracle), the
#   numpy batch split and sign fold the host-decompose pack uses, and the
#   comb, built once per process;
# - the kernels (csrc/glv_verify.cu and, the pair design, csrc/glv_pair.cu):
#   glv_dev_verify (K6, the reference's _glv_dev_program: the split on the
#   card, then the verify), glv_verify (K7, _glv_program: the verify from
#   the host split) and glv_decompose (K7's decompose-only surface,
#   _glv_decompose_program);
# - the plain PyTorch versions, on the w4 plain core above.

LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
# lattice basis for the split (libsecp256k1 scalar_impl.h): a1 + b1 lambda
# == a2 + b2 lambda == 0 (mod n); |k1|, |k2| stay below 2^128 for any k
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_MINUS_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15

GLV_WINDOWS = 32     # 4-bit windows over |k1|, |k2| < 2^128
GLV_COMB_TEETH = 16  # 8-bit fixed-base comb digits over |s| < 2^128


def _round_div(a: int, b: int) -> int:
    """round(a / b) for b > 0, exact (ties round up)."""
    q, r = divmod(a, b)
    return q + (1 if 2 * r >= b else 0)


def glv_split(k: int) -> tuple[int, int]:
    """k (mod n) -> signed (k1, k2) with k == k1 + lambda k2 (mod n) and
    |k1|, |k2| < 2^128, by exact lattice rounding."""
    k %= N
    c1 = _round_div(_GLV_B2 * k, N)
    c2 = _round_div(_GLV_MINUS_B1 * k, N)
    k1 = k - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = c1 * _GLV_MINUS_B1 - c2 * _GLV_B2
    return k1, k2


def glv_decompose(k: int) -> tuple[int, int, int, int]:
    """glv_split with the signs folded out: (|k1|, neg1, |k2|, neg2), neg
    in {0, 1} — the oracle every split of this module is held to."""
    k1, k2 = glv_split(k)
    n1, n2 = int(k1 < 0), int(k2 < 0)
    s1, s2 = abs(k1), abs(k2)
    assert s1 < (1 << 128) and s2 < (1 << 128), (k, k1, k2)
    return s1, n1, s2, n2


# the Barrett constants of the split: c~ = floor(k g / 2^384) is c or c - 1
# of the true c = round(m k / n); one exact-residual bump recovers c
_GLV_G1_INT = _round_div(_GLV_B2 << 384, N)
_GLV_G2_INT = _round_div(_GLV_MINUS_B1 << 384, N)


# ---- the fixed-base comb of G and lambda G ----------------------------------

_GLV_COMB = None
GLV_TABLE_BUILD_S = 0.0  # host build wall time of the comb


def _words_rows(vals: list[int]) -> np.ndarray:
    """ints < 2^256 -> (len, 8) uint32 little-endian words."""
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(blob, "<u4").reshape(len(vals), 8).astype(np.uint32)


def _glv_comb() -> np.ndarray:
    """The fixed-base comb, the reference's layout in the kernel's form:
    (3, GLV_COMB_TEETH, 512, 8) uint32 little-endian words,

        [0, i, s 256 + d] = x(d 256^i G)
        [1, i, s 256 + d] = y(...) for s = 0, p - y(...) for s = 1
        [2, i, s 256 + d] = beta x(...)  (the lambda G stream; phi leaves
                                          y alone, so it shares [1])

    d = 0 entries hold the d = 1 point (the adds mask them out). Built
    once per process from Python-int affine arithmetic (about 4,000
    point adds), timed into GLV_TABLE_BUILD_S."""
    global _GLV_COMB, GLV_TABLE_BUILD_S
    if _GLV_COMB is not None:
        return _GLV_COMB
    t0 = time.monotonic()
    base = G
    xs, ys = [], []
    for _i in range(GLV_COMB_TEETH):
        cur = None
        for _d in range(1, 256):
            cur = point_add(cur, base)
            xs.append(cur[0])
            ys.append(cur[1])
        for _ in range(8):
            base = point_double(base)
    T = GLV_COMB_TEETH
    x = _words_rows(xs).reshape(T, 255, 8)
    y = _words_rows(ys).reshape(T, 255, 8)
    ny = _words_rows([P - v for v in ys]).reshape(T, 255, 8)
    lx = _words_rows([v * BETA % P for v in xs]).reshape(T, 255, 8)
    comb = np.zeros((3, T, 512, 8), np.uint32)
    for c, (pos, neg) in enumerate(((x, x), (y, ny), (lx, lx))):
        comb[c, :, 1:256] = pos
        comb[c, :, 257:512] = neg
        comb[c, :, 0] = pos[:, 0]
        comb[c, :, 256] = neg[:, 0]
    GLV_TABLE_BUILD_S = time.monotonic() - t0
    _GLV_COMB = comb
    return comb


def comb_from_jax(gx, gy, lx) -> np.ndarray:
    """The JAX package's comb ((16, 512, 20) uint32 exact 13-bit limbs
    each) -> the port's (3, 16, 512, 8) uint32 words (_glv_comb's form)."""
    limbs = np.stack([np.asarray(t, np.uint64) for t in (gx, gy, lx)])
    bits = (limbs[..., None] >> np.arange(JAX_LIMB_BITS, dtype=np.uint64)) \
        & np.uint64(1)
    bits = bits.reshape(*limbs.shape[:-1], JAX_N_LIMBS * JAX_LIMB_BITS)
    words = bits[..., :256].reshape(*limbs.shape[:-1], 8, 32)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (words * weights).sum(-1).astype(np.uint32)


_COMB_DEV: dict = {}


def _comb_on(device, form: str) -> torch.Tensor:
    """The comb on ``device``, uploaded once: ``"words"`` (3, 16, 512, 8)
    int32 bit patterns for the kernel, ``"limbs"`` (3, 16, 512, 16) int64
    16-bit limbs for the plain version."""
    key = (str(device), form)
    t = _COMB_DEV.get(key)
    if t is None:
        words = torch.from_numpy(_glv_comb().view(np.int32).copy())
        if form == "limbs":
            w = words.to(torch.int64) & 0xFFFFFFFF
            words = torch.stack([w & MASK, w >> LIMB_BITS], -1).reshape(
                *w.shape[:-1], N_LIMBS)
        t = words.to(device)
        _COMB_DEV[key] = t
    return t


# ---- numpy batch split and sign fold (the host-decompose pack) --------------
# Copied from the reference: 16-bit limbs on uint64, products < 2^32,
# column sums < 2^37.

_NP16_MASK = np.uint64(0xFFFF)


def _np_limbs16(mat: np.ndarray, width: int) -> np.ndarray:
    """(n, nb) uint8 big-endian -> (n, width) uint64 16-bit LE limbs."""
    rev = mat[:, ::-1].astype(np.uint64)
    out = np.zeros((mat.shape[0], width), np.uint64)
    half = mat.shape[1] // 2
    out[:, :half] = rev[:, 0::2] | (rev[:, 1::2] << np.uint64(8))
    return out


def _np_const16(value: int, width: int) -> np.ndarray:
    assert 0 <= value < (1 << (16 * width)), (value, width)
    return np.array([(value >> (16 * i)) & 0xFFFF for i in range(width)],
                    np.uint64)


def _np_mul(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(n, La) exact 16-bit limbs x (Lc,) const -> (n, La + Lc) raw
    columns (u64-safe, un-normalized)."""
    n, La = a.shape
    cols = np.zeros((n, La + len(c)), np.uint64)
    for i, ci in enumerate(c):
        if int(ci):
            cols[:, i:i + La] += a * ci
    return cols


def _np_norm(cols: np.ndarray) -> np.ndarray:
    """Raw columns -> exact 16-bit limbs, same width (value must fit).
    Three rounds collapse any < 2^37 magnitudes to <= 2^16 + 1; the
    residual single-carry ripple is data-dependent on host, so loop
    until quiescent (typically 1-2 more passes) instead of the device
    kernel's fixed worst-case `width` rounds."""
    v = cols
    for _ in range(3):
        carry = v >> np.uint64(16)
        v = v & _NP16_MASK
        v[:, 1:] += carry[:, :-1]
    while True:
        carry = v >> np.uint64(16)
        if not carry.any():
            return v
        v = v & _NP16_MASK
        v[:, 1:] += carry[:, :-1]


def _np_sub(a: np.ndarray, b: np.ndarray) -> tuple:
    """Limbwise a - b with borrow ripple; returns (diff, underflow).
    underflow True where a < b (diff is then the wrapped complement)."""
    n, width = a.shape
    out = np.empty((n, width), np.uint64)
    borrow = np.zeros(n, np.uint64)
    for i in range(width):
        v = a[:, i] - b[:, i] - borrow
        borrow = v >> np.uint64(63)
        out[:, i] = v + (borrow << np.uint64(16))
    return out, borrow.astype(bool)


def _np_ge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ~_np_sub(a, b)[1]


def _np_dbl(v: np.ndarray) -> np.ndarray:
    out = np.zeros((v.shape[0], v.shape[1] + 1), np.uint64)
    out[:, :-1] = (v << np.uint64(1)) & _NP16_MASK
    out[:, 1:] += v >> np.uint64(15)
    return out


def _np_bytes_le(limbs: np.ndarray) -> np.ndarray:
    """(n, L) 16-bit limbs -> (n, 2L) uint8 little-endian bytes."""
    out = np.empty((limbs.shape[0], 2 * limbs.shape[1]), np.uint8)
    out[:, 0::2] = (limbs & np.uint64(0xFF)).astype(np.uint8)
    out[:, 1::2] = ((limbs >> np.uint64(8)) & np.uint64(0xFF)).astype(
        np.uint8)
    return out


def glv_split_batch_np(scalars: np.ndarray) -> tuple:
    """Numpy-vectorized exact lattice split: (n, 32) big-endian scalar
    bytes (each < n) -> (m1 (n, 8) u64 16-bit LE limbs, n1 (n,) bool,
    m2, n2), rounding identical to glv_split (asserted differentially
    by the unit suite)."""
    k = _np_limbs16(np.asarray(scalars, np.uint8), 16)
    n_16 = _np_const16(N, 16)

    def round_quot(g_int: int, m_int: int) -> np.ndarray:
        prod = _np_norm(_np_mul(k, _np_const16(g_int, 16)))    # (n, 32)
        c_est = prod[:, 24:].copy()     # floor(· / 2^384): 24 limbs off
        t = _np_norm(_np_mul(k, _np_const16(m_int, 8)))        # (n, 24)
        cn = _np_norm(_np_mul(c_est, n_16))                    # (n, 24)
        diff, under = _np_sub(t, cn)
        two = _np_dbl(diff)
        plus = (~under) & _np_ge(
            two, np.broadcast_to(_np_const16(N, two.shape[1]), two.shape))
        c_est[:, 0] += plus
        return _np_norm(c_est)

    c1 = round_quot(_GLV_G1_INT, _GLV_B2)
    c2 = round_quot(_GLV_G2_INT, _GLV_MINUS_B1)
    s_cols = _np_mul(c2, _np_const16(_GLV_A2, 9))              # (n, 17)
    s_cols[:, :16] += _np_mul(c1, _np_const16(_GLV_A1, 8))
    s = _np_norm(s_cols)
    k_pad = np.zeros_like(s)
    k_pad[:, :16] = k
    d_ks, n1 = _np_sub(k_pad, s)
    d_sk, _ = _np_sub(s, k_pad)
    m1 = np.where(n1[:, None], d_sk, d_ks)[:, :8]
    p1 = _np_norm(_np_mul(c1, _np_const16(_GLV_MINUS_B1, 8)))  # (n, 16)
    p2 = _np_norm(_np_mul(c2, _np_const16(_GLV_B2, 8)))
    d12, n2 = _np_sub(p1, p2)
    d21, _ = _np_sub(p2, p1)
    m2 = np.where(n2[:, None], d21, d12)[:, :8]
    return m1, n1, m2, n2


def glv_decompose_batch_np(scalars: np.ndarray) -> tuple:
    """glv_decompose, vectorized: (n, 32) big-endian scalar bytes ->
    (|k1| (n, 16) LE bytes, n1 (n,) uint8, |k2| (n, 16) LE bytes, n2)."""
    m1, n1, m2, n2 = glv_split_batch_np(scalars)
    return (_np_bytes_le(m1), n1.astype(np.uint8),
            _np_bytes_le(m2), n2.astype(np.uint8))


def field_neg_bytes_np(yb: np.ndarray) -> np.ndarray:
    """(n, 32) big-endian y (< p) -> (n, 32) big-endian p − y, vectorized
    (the host packer's Q-stream sign fold; y = 0 is never on the curve,
    so the p − 0 = p edge is unreachable from parsed pubkeys)."""
    yl = _np_limbs16(np.asarray(yb, np.uint8), 16)
    d, under = _np_sub(
        np.broadcast_to(_np_const16(P, 16), yl.shape).copy(), yl)
    return _np_bytes_le(d)[:, ::-1]


# ---- the plain PyTorch GLV versions -----------------------------------------

def _t_const(value: int, width: int, device) -> torch.Tensor:
    return torch.tensor([(value >> (16 * i)) & MASK for i in range(width)],
                        dtype=torch.int64, device=device)


def _t_mul(a: torch.Tensor, value: int, width: int) -> torch.Tensor:
    """(B, La) exact 16-bit limbs x a constant of ``width`` limbs ->
    (B, La + width) raw columns (each < 2^37)."""
    cols = torch.zeros(a.shape[0], a.shape[1] + width, dtype=torch.int64,
                       device=a.device)
    for i in range(width):
        c = (value >> (16 * i)) & MASK
        if c:
            cols[:, i:i + a.shape[1]] += a * c
    return cols


def _t_norm(v: torch.Tensor) -> torch.Tensor:
    """Raw non-negative columns -> exact 16-bit limbs, same width, by one
    carry ripple (the value must fit the width)."""
    cols = list(v.unbind(-1))
    for i in range(len(cols) - 1):
        cols[i + 1] = cols[i + 1] + (cols[i] >> LIMB_BITS)
        cols[i] = cols[i] & MASK
    cols[-1] = cols[-1] & MASK
    return torch.stack(cols, -1)


def _t_sub(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Exact limbs a - b with a borrow ripple -> (diff, under): under
    where a < b (diff is then the wrapped complement)."""
    out = []
    borrow = torch.zeros_like(a[:, 0])
    for i in range(a.shape[1]):
        v = a[:, i] - b[:, i] - borrow
        borrow = (v < 0).to(torch.int64)
        out.append(v + (borrow << LIMB_BITS))
    return torch.stack(out, -1), borrow != 0


def glv_split_plain(km: torch.Tensor) -> tuple:
    """The exact limb split of the reference's _glv_split_device (and of
    the kernel's) on (B, 32) uint8 big-endian scalars: c~ = floor(k g /
    2^384), then one bump where e = m k - c~ n has 2e >= n. Returns (m1
    (B, 8) int64 16-bit LE limbs of |k1|, n1 (B,) bool, m2, n2); equal to
    glv_decompose(k) for every k < 2^256."""
    k = _expand_limb_cols(km)                          # (B, 16)
    dev = km.device
    n_25 = _t_const(N, 25, dev).expand(k.shape[0], 25)

    def round_quot(g_int: int, m_int: int) -> torch.Tensor:
        c_est = _t_norm(_t_mul(k, g_int, 16))[:, 24:]   # floor(k g / 2^384)
        t = _t_norm(_t_mul(k, m_int, 8))                # (B, 24)
        cn = _t_norm(_t_mul(c_est, N, 16))              # (B, 24)
        diff, under = _t_sub(t, cn)
        two = _t_norm(F.pad(diff, (0, 1)) * 2)          # (B, 25)
        plus = ~under & ~_t_sub(two, n_25)[1]
        return _t_norm(c_est + F.pad(plus.to(torch.int64)[:, None], (0, 7)))

    c1 = round_quot(_GLV_G1_INT, _GLV_B2)
    c2 = round_quot(_GLV_G2_INT, _GLV_MINUS_B1)
    s = _t_norm(F.pad(_t_mul(c1, _GLV_A1, 8), (0, 1))
                + _t_mul(c2, _GLV_A2, 9))               # (B, 17)
    k_pad = F.pad(k, (0, 1))
    d_ks, n1 = _t_sub(k_pad, s)
    m1 = torch.where(n1[:, None], _t_sub(s, k_pad)[0], d_ks)[:, :8]
    p1 = _t_norm(_t_mul(c1, _GLV_MINUS_B1, 8))          # (B, 16)
    p2 = _t_norm(_t_mul(c2, _GLV_B2, 8))
    d12, n2 = _t_sub(p1, p2)
    m2 = torch.where(n2[:, None], _t_sub(p2, p1)[0], d12)[:, :8]
    return m1, n1, m2, n2


def _comb_digits(m: torch.Tensor) -> torch.Tensor:
    """(B, 8) 16-bit limbs of a value < 2^128 -> (B, 16) int64 8-bit comb
    digits, little-endian (digit i = weight 256^i)."""
    return torch.stack([m & 0xFF, m >> 8], -1).reshape(m.shape[0], 16)


def _nibble_windows(m: torch.Tensor) -> torch.Tensor:
    """(B, 8) 16-bit limbs of a value < 2^128 -> (B, 32) int64 4-bit
    windows, MSB-first (window 0 = bits 127..124)."""
    nib = torch.stack([(m >> s) & 0xF for s in (0, 4, 8, 12)], -1)
    return nib.reshape(m.shape[0], 32).flip(-1)


def _f_neg(y: torch.Tensor) -> torch.Tensor:
    """-y mod p for y with limbs < 2^21 - 32 -> weak."""
    return f_carry(f_sub(torch.zeros_like(y), y))


def _glv_q_tables(qx, qy, ydiff, q_inf) -> tuple:
    """The Q-stream tables (the reference's _glv_q_tables): T1[j] = j Q'
    (Q' = Q with the first Q-stream sign folded into qy), by one doubling
    and 13 cheap mixed adds whose H == 0 flags are ignored; T2[j] =
    (beta X, -+Y, Z) of T1[j], Y negated where ydiff. Entry 0 is a dummy
    (= entry 1; the adds mask it out). Returns two (X, Y, Z) tuples of
    (16, B, 16) stacks."""
    c = _consts(qx.device)
    one = c["one"].expand_as(qx)
    q1 = (qx, qy, one, q_inf)
    tab = [q1, pt_double(q1)]
    for _j in range(3, 16):
        added, _hz = _pt_add_mixed_cheap_u(tab[-1], qx, qy, q_inf)
        tab.append(added)
    entries = [tab[0]] + tab
    t1 = tuple(torch.stack([e[k] for e in entries]) for k in range(3))
    t2 = (f_mul(c["beta"], t1[0]),
          torch.where(ydiff[:, None], _f_neg(t1[1]), t1[1]), t1[2])
    return t1, t2


def _glv_window_step(carry: tuple, w1, w2, t1, t2, q_inf) -> tuple:
    """One ladder window: 4 doublings, then the Q-stream full add (w1 from
    T1), then the lambda Q-stream full add (w2 from T2). w1/w2: (B,) int64
    window values."""
    acc, degen = carry
    for _ in range(4):
        acc = pt_double(acc)
    lane = torch.arange(w1.shape[0], device=w1.device)
    for t, w in ((t1, w1), (t2, w2)):
        q_sel = tuple(c[w, lane] for c in t) + (q_inf,)
        act = (w != 0) & ~q_inf
        added, hz = _pt_add_full_cheap_u(acc, q_sel)
        acc = pt_select(act, added, acc)
        degen = degen | (hz & act)
    return acc, degen


def _glv_comb_step(carry: tuple, drow, sgrow, tab_x, tab_y) -> tuple:
    """One comb tooth for one G stream: the cheap mixed add of the entry
    sgrow + drow of this tooth's (512, 16) tables (drow: (B,) digits,
    0 = skip; sgrow: (B,) sign x 256)."""
    acc, degen = carry
    idx = sgrow + drow
    act = drow != 0
    added, hz = _pt_add_mixed_cheap_u(acc, tab_x[idx], tab_y[idx],
                                      torch.zeros_like(act))
    acc = pt_select(act, added, acc)
    degen = degen | (hz & act)
    return acc, degen


def _verify_core_glv(w1, w2, d1, sg1, d2, sg2, qx, qy, ydiff, q_inf, r0, rn,
                     wrap) -> tuple:
    """The GLV verify core (the reference's _verify_core_glv). w1/w2:
    (B, 32) int64 MSB-first windows of |k1|, |k2| of u2 (the Q and lambda
    Q streams); d1/d2: (B, 16) int64 comb digits of |k1|, |k2| of u1 (the
    G and lambda G streams); sg1/sg2: (B,) bool G-stream signs; qx/qy:
    (B, 16) limbs, qy with the first Q-stream sign folded; ydiff, q_inf,
    wrap: (B,) bool. Returns (ok, degen) (B,) bool."""
    B = qx.shape[0]
    dev = qx.device
    t1, t2 = _glv_q_tables(qx, qy, ydiff, q_inf)
    gx, gy, lx = _comb_on(dev, "limbs")
    one = _consts(dev)["one"].expand_as(qx)
    acc = (one, one, torch.zeros_like(qx),
           torch.ones(B, dtype=torch.bool, device=dev))
    carry = (acc, torch.zeros(B, dtype=torch.bool, device=dev))
    for k in range(GLV_WINDOWS):
        carry = _glv_window_step(carry, w1[:, k], w2[:, k], t1, t2, q_inf)
    o1 = sg1.to(torch.int64) * 256
    o2 = sg2.to(torch.int64) * 256
    for i in range(GLV_COMB_TEETH):
        carry = _glv_comb_step(carry, d1[:, i], o1, gx[i], gy[i])
        carry = _glv_comb_step(carry, d2[:, i], o2, lx[i], gy[i])
    return _verify_final(carry[0], carry[1], q_inf, r0, rn, wrap)


def _on_live_lanes(fn, qinf8, *args) -> tuple:
    """A plain verify on the lanes whose q_inf is clear only: a q_inf lane
    (padding, or a poisoned record) reports ok = degen = 0 and does no
    work, as in the kernels. args are lanes-first tensors."""
    live = torch.nonzero(qinf8 == 0).squeeze(1)
    if live.numel() == qinf8.shape[0]:
        return fn(*args)
    ok = torch.zeros(qinf8.shape[0], dtype=torch.bool, device=qinf8.device)
    degen = torch.zeros_like(ok)
    if live.numel():
        ok[live], degen[live] = fn(*[a[live] for a in args])
    return ok, degen


def glv_dev_verify_plain(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8):
    """The plain version of ecdsa_verify_batch_glv_dev (the reference's
    _glv_dev_program) on the inputs' own device: the split of u1 and u2,
    the sign fold of qy and ydiff, then the core (live lanes only)."""
    return _on_live_lanes(_glv_dev_verify_live, qinf8, u1m, u2m, qxb, qyb,
                          qinf8, r0b, rnb, wrap8)


def _glv_dev_verify_live(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8):
    B = qxb.shape[0]
    m1, n1, m2, n2 = glv_split_plain(torch.cat([u1m, u2m]))
    qy = _expand_limb_cols(qyb)
    nb1, nb2 = n1[B:], n2[B:]
    qy = _where(nb1, _f_neg(qy), qy)
    return _verify_core_glv(
        _nibble_windows(m1[B:]), _nibble_windows(m2[B:]),
        _comb_digits(m1[:B]), n1[:B], _comb_digits(m2[:B]), n2[:B],
        _expand_limb_cols(qxb), qy, nb1 ^ nb2, qinf8 != 0,
        _expand_limb_cols(r0b), _expand_limb_cols(rnb), wrap8 != 0)


def glv_verify_plain(d1m, d2m, sg1v, sg2v, s1m, s2m, ydiff8, qxb, qyb, qinf8,
                     r0b, rnb, wrap8):
    """The plain version of ecdsa_verify_batch_glv (the reference's
    _glv_program) on the inputs' own device (live lanes only)."""
    return _on_live_lanes(_glv_verify_live, qinf8, d1m, d2m, sg1v, sg2v,
                          s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b, rnb, wrap8)


def _glv_verify_live(d1m, d2m, sg1v, sg2v, s1m, s2m, ydiff8, qxb, qyb, qinf8,
                     r0b, rnb, wrap8):
    return _verify_core_glv(
        _expand_nibble_windows(s1m).T, _expand_nibble_windows(s2m).T,
        d1m.to(torch.int64), sg1v != 0, d2m.to(torch.int64), sg2v != 0,
        _expand_limb_cols(qxb), _expand_limb_cols(qyb), ydiff8 != 0,
        qinf8 != 0, _expand_limb_cols(r0b), _expand_limb_cols(rnb),
        wrap8 != 0)


def glv_decompose_plain(km):
    """The plain version of glv_decompose_device_batch: (B, 32) uint8
    big-endian scalars -> (|k1| (B, 16) uint8 LE, n1 (B,) uint8, |k2|,
    n2)."""
    m1, n1, m2, n2 = glv_split_plain(km)
    u8 = torch.uint8
    return (_comb_digits(m1).to(u8), n1.to(u8), _comb_digits(m2).to(u8),
            n2.to(u8))


# ---- the GLV kernels: launch ------------------------------------------------

# lanes a launch at most: the reference's program split
GLV_SPLIT = 16384


def _u8(tensors: list) -> list:
    return [t.to(torch.uint8).contiguous() for t in tensors]


def ecdsa_verify_batch_glv_dev(u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8):
    """Byte-matrix GLV verify with the split on the device (K6): the w4
    byte entry's inputs ((B, 32) uint8 big-endian u1, u2, qx, qy, r0, rn;
    (B,) uint8 q_inf and wrap). Returns (ok, degen) (B,) bool on the
    inputs' device; degen lanes must be re-verified on the host."""
    B = qxb.shape[0]
    dev = qxb.device
    _check([u1m, u2m, qxb, qyb, r0b, rnb], dev, [(B, 32)] * 6,
           (torch.uint8,))
    _check([qinf8, wrap8], dev, [(B,)] * 2, (torch.uint8, torch.bool))
    if dev.type == "cpu":
        return glv_dev_verify_plain(u1m, u2m, qxb, qyb, qinf8, r0b, rnb,
                                    wrap8)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no GLV kernel for device {dev}")
    ok, degen = _launch("glv_dev_verify", _u8(
        [u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8]), B)
    return ok.view(torch.bool), degen.view(torch.bool)


def ecdsa_verify_batch_glv(d1m, d2m, sg1v, sg2v, s1m, s2m, ydiff8, qxb, qyb,
                           qinf8, r0b, rnb, wrap8):
    """Byte-matrix GLV verify from the host split (K7; the arrays of
    ops/ecdsa_batch._glv_pack_parts): (B, 16) uint8 comb digits d1m/d2m
    (little-endian) and ladder magnitudes s1m/s2m (big-endian), (B,)
    uint8 signs sg1v/sg2v and ydiff8, (B, 32) uint8 qx and sign-folded
    qy, r0, rn, (B,) uint8 q_inf and wrap. Returns (ok, degen) (B,)
    bool."""
    B = qxb.shape[0]
    dev = qxb.device
    _check([d1m, d2m, s1m, s2m], dev, [(B, 16)] * 4, (torch.uint8,))
    _check([qxb, qyb, r0b, rnb], dev, [(B, 32)] * 4, (torch.uint8,))
    _check([sg1v, sg2v, ydiff8, qinf8, wrap8], dev, [(B,)] * 5,
           (torch.uint8, torch.bool))
    args = [d1m, d2m, sg1v, sg2v, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b,
            rnb, wrap8]
    if dev.type == "cpu":
        return glv_verify_plain(*args)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no GLV kernel for device {dev}")
    ok, degen = _launch("glv_verify", _u8(args), B)
    return ok.view(torch.bool), degen.view(torch.bool)


_DECOMPOSE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]


def glv_decompose_device_batch(km):
    """The split alone on the device: (B, 32) uint8 big-endian scalars ->
    (|k1| (B, 16) uint8 little-endian, n1 (B,) uint8, |k2|, n2) on the
    inputs' device (the reference takes and returns numpy; here tensors,
    as every wrapper of the port)."""
    B = km.shape[0]
    dev = km.device
    _check([km], dev, [(B, 32)], (torch.uint8,))
    if dev.type == "cpu":
        return glv_decompose_plain(km)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no GLV kernel for device {dev}")
    fn = cuda_build.entry("glv_decompose", _DECOMPOSE_ARGS)
    # one allocation for the four outputs (|k1|, |k2|, n1, n2 back to
    # back), as the verify wrappers allocate one or two
    out = torch.empty(34 * B, dtype=torch.uint8, device=dev)
    m1, m2 = out[:16 * B].view(B, 16), out[16 * B:32 * B].view(B, 16)
    n1, n2 = out[32 * B:33 * B], out[33 * B:]
    k, o = km.contiguous().data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for s in range(0, B, GLV_SPLIT):
        n = min(GLV_SPLIT, B - s)
        rc = fn(k + 32 * s, o + 16 * s, o + 32 * B + s, o + 16 * (B + s),
                o + 33 * B + s, n, stream)
        cuda_build.check_launch("glv_decompose", rc)
        LAUNCHES["glv_decompose"] += 1
        LAUNCH_SHAPES[("glv_decompose", n)] = \
            LAUNCH_SHAPES.get(("glv_decompose", n), 0) + 1
    return m1, n1, m2, n2


# ---- Schnorr MSM: the Pippenger batch check (K9) ----------------------------
#
# Port of the MSM part of the reference's ops/secp256k1.py (_msm_accumulate,
# _msm_program, _msm_partial_program and their host entries). The batch
# check asks whether sum_j k_j Q_j over the packed terms is the point at
# infinity. Only that sum is the contract, so the schedule is the kernel's
# own (csrc/msm.cu, whose head note gives it in full), shared with the
# plain version below so that the two agree on the sum's Jacobian triple:
# each term splits by GLV into (|k1|, +-Q) and (|k2|, +-phi(Q)), terms j
# and M + j of 2M; K streams (msm_streams) of 2M / K terms, lane 32 k + w
# of stream k keeps 15 buckets and adds each of its stream's terms into
# bucket (the w-th 4-bit window of the term's 128-bit magnitude, MSB
# first) by a complete mixed add; the streams merge pairwise (log2 K
# complete full adds, the lower stream first); each window's weighted
# bucket sum is sum_i 2^i T_i over the bit sums T_i (add trees), and the
# 32 window sums join in a log-depth tree (2^(4 2^l) A + B at level l).
# Every add is complete: an adversary controls the terms, so P == Q and
# P == -Q do occur.

# more streams: shorter bucket walks, more merge levels, more bucket
# scratch; M / 16 streams keep every walk at 32 terms (2M / K) up to
# M = 8192, and the cap keeps the scratch at half the card's L2 (64 terms
# at M = 16384; see csrc/msm.cu)
_MSM_STREAM_CAP = 512
MSM_WINDOWS = 32     # 4-bit windows of a 128-bit GLV magnitude
MSM_BUCKETS = 15     # digits 1 .. 15
MSM_TERM_WORDS = 24  # a split term in csrc/msm.cu's scratch
# the 25 words of csrc/msm.cu's result: canonical X, Y, Z (8 little-endian
# words each; X = Y = 1, Z = 0 at infinity) and the infinity flag
MSM_WORDS = 25


def msm_streams(M: int) -> int:
    """The stream count K of an M-term MSM: the largest power of two at
    most min(512, M / 16) (1 below 32 terms)."""
    k = 1
    while 2 * k <= min(_MSM_STREAM_CAP, M // 16):
        k *= 2
    return k


def msm_scratch_words(M: int) -> dict:
    """The int32 words of csrc/msm.cu's scratch for an M-term MSM, in
    msm_run's order: the split terms, the buckets (15 x 25 a lane, 32
    lanes a stream) and the 32 window sums."""
    K = msm_streams(M)
    return {"terms": MSM_TERM_WORDS * 2 * M,
            "buckets": MSM_BUCKETS * MSM_WORDS * MSM_WINDOWS * K,
            "windows": MSM_WINDOWS * MSM_WORDS}


def _inf_points(n: int, device) -> tuple:
    one = _consts(device)["one"].expand(n, N_LIMBS)
    return (one, one, torch.zeros(n, N_LIMBS, dtype=torch.int64,
                                  device=device),
            torch.ones(n, dtype=torch.bool, device=device))


def _same_opposite(H, R, finite, tally) -> tuple:
    """(P == Q, P == -Q) lane masks of a complete add between finite
    points: H == 0 and R == 0, or H == 0 and R != 0 (exact mod p; one
    zero test over both). ``tally`` (a dict, or None) counts the lanes of
    each case under "same" and "opposite"."""
    zero = f_is_zero(torch.stack([H, R]))
    same = zero[0] & zero[1] & finite
    opposite = zero[0] & ~zero[1] & finite
    if tally is not None:
        tally["same"] = tally.get("same", 0) + int(same.sum())
        tally["opposite"] = tally.get("opposite", 0) + int(opposite.sum())
    return same, opposite


def _with_doubles(same, pt: tuple, out: tuple) -> tuple:
    """out, with double(P) on the lanes where P == Q (the double is
    computed only when some lane needs it)."""
    if not bool(same.any()):
        return out
    return pt_select(same, pt_double(pt), out)


def pt_add_mixed(pt: tuple, qx, qy, q_inf, tally=None) -> tuple:
    """Complete mixed add P (Jacobian) + Q (affine), the reference's
    pt_add_mixed: P = inf -> Q; Q = inf -> P; P == Q -> double(P);
    P == -Q -> infinity; else madd (Z1Z1 = Z^2, U2 = qx Z1Z1, S2 = qy Z
    Z1Z1, H = U2 - X, R = S2 - Y, X3 = R^2 - HHH - 2V, Y3 = R (V - X3) -
    Y HHH, Z3 = Z H). The zero tests on H and R are exact mod p. tally:
    see _same_opposite."""
    X, Y, Z, inf = pt
    Z1Z1 = f_sqr(Z)
    U2 = f_mul(qx, Z1Z1)
    S2 = f_mul(qy, f_mul(Z, Z1Z1))
    H = f_carry_sub(U2, X)
    R = f_carry_sub(S2, Y)
    same, opposite = _same_opposite(H, R, ~inf & ~q_inf, tally)
    HH = f_sqr(H)
    HHH = f_mul(H, HH)
    V = f_mul(X, HH)
    X3 = f_carry_sub(f_sqr(R), f_add(HHH, f_add(V, V)))
    Y3 = f_carry_sub(f_mul(R, f_sub(V, X3)), f_mul(Y, HHH))
    Z3 = f_mul(Z, H)
    out = _with_doubles(same, pt, (X3, Y3, Z3, opposite))
    one = _consts(X.device)["one"].expand_as(X)
    out = pt_select(inf, (qx.expand_as(X), qy.expand_as(X), one, q_inf), out)
    return pt_select(q_inf & ~inf, pt, out)


def pt_add_full(pt: tuple, q: tuple, tally=None) -> tuple:
    """Complete Jacobian add P + Q, the reference's pt_add_full (the
    add-2007-bl core of _pt_add_full_cheap_u with the same case analysis
    as pt_add_mixed)."""
    X1, Y1, Z1, inf1 = pt
    X2, Y2, Z2, inf2 = q
    Z1Z1 = f_sqr(Z1)
    Z2Z2 = f_sqr(Z2)
    U1 = f_mul(X1, Z2Z2)
    U2 = f_mul(X2, Z1Z1)
    S1 = f_mul(Y1, f_mul(Z2, Z2Z2))
    S2 = f_mul(Y2, f_mul(Z1, Z1Z1))
    H = f_carry_sub(U2, U1)
    R = f_carry_sub(S2, S1)
    same, opposite = _same_opposite(H, R, ~inf1 & ~inf2, tally)
    HH = f_sqr(H)
    HHH = f_mul(H, HH)
    V = f_mul(U1, HH)
    X3 = f_carry_sub(f_sqr(R), f_add(HHH, f_add(V, V)))
    Y3 = f_carry_sub(f_mul(R, f_sub(V, X3)), f_mul(S1, HHH))
    Z3 = f_mul(f_mul(Z1, Z2), H)
    out = _with_doubles(same, pt, (X3, Y3, Z3, opposite))
    out = pt_select(inf1, q, out)
    return pt_select(inf2 & ~inf1, pt, out)


def _pt_doubles(pt: tuple, times: int) -> tuple:
    for _ in range(times):
        pt = pt_double(pt)
    return pt


def _pt_take(pt: tuple, idx) -> tuple:
    return tuple(t[idx] for t in pt)


def msm_split_plain(xm, ym, inf8, km) -> tuple:
    """The GLV split of the terms (csrc/msm.cu's msm_split): (M, 32) uint8
    big-endian xm, ym, km and (M,) inf8 -> the 2M split terms, term j =
    (|k1_j|, +-Q_j) and term M + j = (|k2_j|, +-phi(Q_j)): x, y (2M, 16)
    limbs, inf (2M,) bool and the magnitudes' MSB-first 4-bit windows
    (2M, 32) int64."""
    m1, n1, m2, n2 = glv_split_plain(km)
    x = _expand_limb_cols(xm)
    y = _expand_limb_cols(ym)
    ny = _f_neg(y)
    bx = f_mul(x, _consts(x.device)["beta"])
    inf = inf8 != 0
    return (torch.cat([x, bx]),
            torch.cat([_where(n1, ny, y), _where(n2, ny, y)]),
            torch.cat([inf, inf]), _nibble_windows(torch.cat([m1, m2])))


def _walk_layout(win: torch.Tensor, K: int) -> torch.Tensor:
    """(2M, 32) windows of the split terms -> (32 K, 2M / K): row 32 k + w
    holds the w-th window of stream k's terms in order."""
    steps = win.shape[0] // K
    return win.reshape(K, steps, MSM_WINDOWS).permute(0, 2, 1).reshape(
        K * MSM_WINDOWS, steps)


def msm_digits(km) -> torch.Tensor:
    """(M, 32) uint8 big-endian scalars -> (32 K, 2M / K) int64 digits: row
    32 k + w holds the w-th 4-bit window (MSB first) of the magnitudes of
    stream k's split terms in order (the walk's layout)."""
    m1, _n1, m2, _n2 = glv_split_plain(km)
    return _walk_layout(_nibble_windows(torch.cat([m1, m2])),
                        msm_streams(km.shape[0]))


def msm_buckets_plain(xm, ym, inf8, km, tally=None) -> tuple:
    """The split and the bucket walk (csrc/msm.cu's msm_split and
    msm_buckets): (M, 32) uint8 big-endian xm, ym, km and (M,) inf8 -> the
    buckets (X, Y, Z) as (32 K, 16, 16) limbs and inf (32 K, 16), lane
    32 k + w, bucket d (bucket 0 unused, at infinity)."""
    M = xm.shape[0]
    K = msm_streams(M)
    steps, lanes, dev = 2 * M // K, K * MSM_WINDOWS, xm.device
    tx, ty, tinf, win = msm_split_plain(xm, ym, inf8, km)
    xs = tx.reshape(K, steps, N_LIMBS)
    ys = ty.reshape(K, steps, N_LIMBS)
    p_inf = tinf.reshape(K, steps)
    digits = _walk_layout(win, K)
    one = _consts(dev)["one"]
    bX = one.expand(lanes, 16, N_LIMBS).clone()
    bY = bX.clone()
    bZ = torch.zeros_like(bX)
    binf = torch.ones(lanes, 16, dtype=torch.bool, device=dev)
    for t in range(steps):
        d = digits[:, t]
        qi = p_inf[:, t].repeat_interleave(MSM_WINDOWS)
        hit = (d > 0) & ~qi
        rows = hit.nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        cols = d[rows]
        k = rows // MSM_WINDOWS
        new = pt_add_mixed(
            (bX[rows, cols], bY[rows, cols], bZ[rows, cols],
             binf[rows, cols]),
            xs[k, t], ys[k, t], torch.zeros_like(qi[rows]), tally)
        bX[rows, cols], bY[rows, cols], bZ[rows, cols] = new[:3]
        binf[rows, cols] = new[3]
    return bX, bY, bZ, binf


def msm_merge_plain(buckets: tuple, K: int, tally=None) -> tuple:
    """The pairwise stream merge (csrc/msm.cu's msm_merge levels): the
    buckets of msm_buckets_plain -> the 32 windows' buckets of the sum,
    (32, 16, 16) limbs and (32, 16) inf."""
    per = MSM_WINDOWS * 16
    cur = tuple(t.reshape(K, per, *t.shape[2:]) for t in buckets)
    k = K
    while k > 1:
        half = k // 2
        lo = tuple(t[:half].reshape(half * per, *t.shape[2:]) for t in cur)
        hi = tuple(t[half:].reshape(half * per, *t.shape[2:]) for t in cur)
        cur = tuple(t.reshape(half, per, *t.shape[1:])
                    for t in pt_add_full(lo, hi, tally))
        k = half
    return tuple(t.reshape(MSM_WINDOWS, 16, *t.shape[2:]) for t in cur)


# the digits 1 .. 15 whose bit i is set, in increasing order: bit sum T_i's
# 8 buckets (csrc/msm.cu's msm_reduce)
_BIT_BUCKETS = [[b for b in range(1, 16) if (b >> i) & 1] for i in range(4)]


def msm_reduce_plain(windows: tuple, tally=None) -> tuple:
    """The weighted bucket sums (csrc/msm.cu's msm_reduce): the windows'
    buckets -> the 32 window sums sum_b b B_b as (32, 16) limbs and (32,)
    inf: T_i = the add tree of the 8 buckets whose bit i is set (pairs in
    increasing b, then the lower subtree first), C1 = 2 T3 + T2,
    C0 = 2 T1 + T0, then 4 C1 + C0."""
    idx = torch.tensor(_BIT_BUCKETS, device=windows[0].device)  # (4, 8)
    pts = tuple(t[:, idx] for t in windows)  # (32, 4, 8, ...)
    while pts[3].shape[-1] > 1:
        n = pts[3].shape[-1] // 2
        lo = tuple(t[:, :, 0::2].reshape(-1, *t.shape[3:]) for t in pts)
        hi = tuple(t[:, :, 1::2].reshape(-1, *t.shape[3:]) for t in pts)
        pts = tuple(t.reshape(MSM_WINDOWS, 4, n, *t.shape[1:])
                    for t in pt_add_full(lo, hi, tally))
    bits = tuple(t[:, :, 0] for t in pts)  # (32, 4, ...): T0 .. T3
    hi = tuple(t[:, [3, 1]].reshape(-1, *t.shape[2:]) for t in bits)
    lo = tuple(t[:, [2, 0]].reshape(-1, *t.shape[2:]) for t in bits)
    C = tuple(t.reshape(MSM_WINDOWS, 2, *t.shape[1:])
              for t in pt_add_full(_pt_doubles(hi, 1), lo, tally))
    return pt_add_full(_pt_doubles(_pt_take(C, (slice(None), 0)), 2),
                       _pt_take(C, (slice(None), 1)), tally)


def msm_combine_plain(wsums: tuple, tally=None) -> tuple:
    """The window combination (csrc/msm.cu's msm_combine): the 32 window
    sums, window 0 the most significant -> the sum as a width-1 point;
    level l joins groups A, B of 2^l windows as 2^(4 2^l) A + B."""
    g = wsums
    for level in range(5):
        a = _pt_doubles(_pt_take(g, slice(0, None, 2)), 4 << level)
        g = pt_add_full(a, _pt_take(g, slice(1, None, 2)), tally)
    return g


def msm_accumulate_plain(xm, ym, inf8, km, tally=None) -> tuple:
    """The plain MSM on the kernel's schedule: the Jacobian sum
    (X, Y, Z, inf) at width 1 (limbs; coordinates meaningless under inf).
    ``tally`` (a dict, or None) receives the lanes where a complete add
    met P == Q ("same") and P == -Q ("opposite"), per stage: "walk",
    "merge", "reduce", "combine"."""
    t = {} if tally is None else tally
    K = msm_streams(xm.shape[0])
    buckets = msm_buckets_plain(xm, ym, inf8, km, t.setdefault("walk", {}))
    windows = msm_merge_plain(buckets, K, t.setdefault("merge", {}))
    return msm_combine_plain(
        msm_reduce_plain(windows, t.setdefault("reduce", {})),
        t.setdefault("combine", {}))


def _point_result(pt: tuple) -> tuple:
    """A width-1 point -> ((X, Y, Z) canonical ints, inf), with the
    kernel's (1, 1, 0) at infinity."""
    if bool(pt[3][0]):
        return (1, 1, 0), True
    return tuple(from_limbs(c)[0] % P for c in pt[:3]), False


def _words_result(words: torch.Tensor) -> tuple:
    """csrc/msm.cu's 25 result words -> ((X, Y, Z) ints, inf)."""
    w = [int(v) & 0xFFFFFFFF for v in words.to("cpu").tolist()]
    coords = tuple(sum(w[8 * c + i] << (32 * i) for i in range(8))
                   for c in range(3))
    return coords, bool(w[24])


def _msm_tensors(xm, ym, inf8, km) -> list:
    """The four inputs as tensors on one device (numpy arrays go to the
    port's device), checked: (M, 32) uint8 xm, ym, km; (M,) uint8 or
    bool inf8; 2M a multiple of the stream count."""
    ts = [a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.uint8))).to(cuda_build.device())
        for a in (xm, ym, inf8, km)]
    M = ts[0].shape[0]
    dev = ts[0].device
    _check([ts[0], ts[1], ts[3]], dev, [(M, 32)] * 3, (torch.uint8,))
    _check([ts[2]], dev, [(M,)], (torch.uint8, torch.bool))
    if ts[2].dtype == torch.bool:
        ts[2] = ts[2].to(torch.uint8)
    ts = [t.contiguous() for t in ts]
    if M < 1 or (2 * M) % msm_streams(M):
        raise ValueError(f"M={M}: its {2 * M} split terms are not a "
                         f"multiple of its stream count {msm_streams(M)}")
    return ts


# csrc/msm.cu's scratch, kept per (card, M, stream): the launches on one
# stream run in order, so they share it; two streams of one card (the
# sharded MSM's [cuda:0] * 4) each have their own
_MSM_SCRATCH: dict = {}
_MSM_RUN_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _msm_scratch(dev, M: int, stream) -> list:
    key = (dev.index, M, stream.cuda_stream)
    scratch = _MSM_SCRATCH.get(key)
    if scratch is None:
        scratch = _MSM_SCRATCH[key] = [
            torch.empty(n, dtype=torch.int32, device=dev)
            for n in msm_scratch_words(M).values()]
    return scratch


def msm_plan(name: str, ts: list, scratch: list, out: torch.Tensor):
    """A prepared launch of csrc/msm.cu's whole MSM (entry msm_run: the
    split, the bucket walk, the merge levels, the reduction, the
    combination), counted as ``name`` (msm or msm_partial): ``ts``
    _msm_tensors' contiguous CUDA inputs (inf8 uint8), ``scratch`` the
    msm_scratch_words buffers and ``out`` the (25,) int32 result words,
    all on one card. Returns ``launch(stream)``, which launches on the
    CUDA stream handle ``stream`` and holds the tensors whose pointers it
    took; scratch is the caller's to keep apart from any launch on another
    stream."""
    M = ts[0].shape[0]
    fn = cuda_build.entry("msm_run", _MSM_RUN_ARGS)
    args = (*[t.data_ptr() for t in ts + scratch], out.data_ptr(), M,
            msm_streams(M))

    def launch(stream: int, _keep=(ts, scratch, out)) -> None:
        cuda_build.check_launch("msm_run", fn(*args, stream))
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, M)] = LAUNCH_SHAPES.get((name, M), 0) + 1
    return launch


def _msm_launch(name: str, ts: list) -> torch.Tensor:
    """Launch the whole MSM (msm_plan) on the current stream; returns its
    25 result words (int32) on the card. The scratch is kept per (card, M,
    stream)."""
    dev = ts[0].device
    stream = torch.cuda.current_stream(dev)
    out = torch.empty(MSM_WORDS, dtype=torch.int32, device=dev)
    msm_plan(name, ts, _msm_scratch(dev, ts[0].shape[0], stream),
             out)(stream.cuda_stream)
    return out


def _msm_result(name: str, xm, ym, inf8, km) -> tuple:
    """The MSM's ((X, Y, Z), inf): the kernel's launch, read back (CUDA),
    or its plain version (CPU)."""
    ts = _msm_tensors(xm, ym, inf8, km)
    dev = ts[0].device
    if dev.type == "cpu":
        return _point_result(msm_accumulate_plain(*ts))
    if dev.type != "cuda":
        raise KernelUnavailable(f"no MSM kernel for device {dev}")
    return _words_result(_msm_launch(name, ts))


def schnorr_msm_is_infinity(xm, ym, inf8, km) -> np.ndarray:
    """The batch check's host entry (the reference's, K9): is sum_j k_j Q_j
    the point at infinity, as a (1,) uint32 numpy array (1 = the batch
    accepts). xm, ym, km: (M, 32) uint8 big-endian affine terms and
    scalars (< n); inf8: (M,) flags of terms that add nothing; tensors
    (CUDA: the kernel; CPU: the plain version) or numpy arrays (moved to
    the port's device). Waits for the card."""
    _coords, inf = _msm_result("msm", xm, ym, inf8, km)
    return np.array([1 if inf else 0], np.uint32)


def msm_partial_point(xm, ym, inf8, km) -> tuple:
    """One shard's partial sum (the reference's host entry): ((X, Y, Z)
    ints mod p, inf bool), the Jacobian triple of the kernel's schedule,
    canonical, (1, 1, 0) at infinity. Inputs as
    schnorr_msm_is_infinity's."""
    return _msm_result("msm_partial", xm, ym, inf8, km)


# ---- the bit ladder (K8) -----------------------------------------------------
#
# Port of the reference's ecdsa_verify_batch_device (:463) behind
# ecdsa_verify_batch_jit (:508-512): the ECDSA rung the reference's
# dispatch runs when BCP_SECP_PALLAS=0 turns the w4 kernels off, on
# pack_records' planes. The reference's schedule is an MSB-first joint
# double-and-add (ladder_step, ladder_verify_plain): 256 steps of a
# doubling, the complete mixed add of G where the u1 bit is set and that
# of Q where the u2 bit is set and Q is finite; then X == r0 Z^2, or
# X == rn Z^2 where wrap_ok allows it, with q_inf lanes False. Only that
# verdict is the contract, and it is the group law's, exactly (every add is
# complete; there is no degen plane), so the kernel (csrc/ladder_verify.cu,
# entry ladder_verify) runs a joint 4-bit window ladder instead, a quarter
# of the doublings' steps; its plain version, ladder_windowed_plain, serves
# CPU tensors and the comparison on the card, and is held against the bit
# ladder in the tests.


def ladder_step(acc: tuple, b1, b2, qx, qy, q_inf) -> tuple:
    """One step of the reference's ladder: double, then + G where b1, then
    + Q where b2 and Q is finite (b1, b2, q_inf: (B,) bool)."""
    c = _consts(qx.device)
    acc = pt_double(acc)
    with_g = pt_add_mixed(acc, c["gx"][1].expand_as(qx),
                          c["gy"][1].expand_as(qx), torch.zeros_like(q_inf))
    acc = pt_select(b1, with_g, acc)
    with_q = pt_add_mixed(acc, qx, qy, q_inf)
    return pt_select(b2 & ~q_inf, with_q, acc)


def ladder_verify_plain(u1_bits, u2_bits, qx, qy, q_inf, r0, rn, wrap_ok):
    """The plain PyTorch bit ladder (the reference's
    ecdsa_verify_batch_device) in the port's layout: u1_bits, u2_bits
    (B, 256) bool, MSB first; qx, qy, r0, rn (B, 16) limbs; q_inf,
    wrap_ok (B,) bool. Returns ok (B,) bool."""
    acc = _inf_points(qx.shape[0], qx.device)
    for i in range(256):
        acc = ladder_step(acc, u1_bits[:, i], u2_bits[:, i], qx, qy, q_inf)
    ok, _degen = _verify_final(acc, torch.zeros_like(q_inf), q_inf, r0, rn,
                               wrap_ok)
    return ok


def _windows_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, 256) bool, MSB first -> (B, 64) int64 4-bit windows, MSB
    first."""
    w = bits.to(torch.int64).reshape(bits.shape[0], 64, 4)
    return (w[..., 0] << 3) | (w[..., 1] << 2) | (w[..., 2] << 1) | w[..., 3]


def ladder_windowed_plain(u1_bits, u2_bits, qx, qy, q_inf, r0, rn, wrap_ok,
                          tally=None):
    """The plain version of csrc/ladder_verify.cu's windowed ladder, in
    ladder_verify_plain's layout and with its verdict: the Q table (Q, 2Q
    by a doubling, then jQ = (j - 1) Q + Q by complete mixed adds), then
    64 windows MSB first of 4 doublings, + d1 G (G's affine table) where
    u1's digit d1 is not 0, + d2 Q (the Q table, a complete full add)
    where u2's digit d2 is not 0 and Q is finite. ``tally`` (a dict, or
    None) counts the lanes where a window's add met P == Q ("same") or
    P == -Q ("opposite")."""
    c = _consts(qx.device)
    B = qx.shape[0]
    d1 = _windows_of_bits(u1_bits)
    d2 = _windows_of_bits(u2_bits)
    finite = torch.zeros_like(q_inf)
    tab = [(qx, qy, c["one"].expand_as(qx), finite)]
    tab.append(pt_double(tab[0]))
    for _j in range(3, 16):
        tab.append(pt_add_mixed(tab[-1], qx, qy, finite))
    q_tab = tuple(torch.stack([e[k] for e in tab]) for k in range(4))
    lane = torch.arange(B, device=qx.device)
    acc = _inf_points(B, qx.device)
    for i in range(64):
        acc = _pt_doubles(acc, 4)
        g = d1[:, i]
        with_g = pt_add_mixed(acc, c["gx"][g], c["gy"][g], g == 0, tally)
        acc = pt_select(g != 0, with_g, acc)
        q = d2[:, i]
        on = (q != 0) & ~q_inf
        entry = tuple(t[(q - 1).clamp(min=0), lane] for t in q_tab)
        with_q = pt_add_full(acc, entry[:3] + (~on,), tally)
        acc = pt_select(on, with_q, acc)
    ok, _degen = _verify_final(acc, torch.zeros_like(q_inf), q_inf, r0, rn,
                               wrap_ok)
    return ok


def ladder_planes_plain(u1_bits, u2_bits, qx, qy, q_inf, r0, rn, wrap_ok):
    """The plain version of ecdsa_verify_batch_jit on pack_records'
    planes (the kernel's windowed schedule), converted to the port's
    layout on the inputs' own device."""
    return ladder_windowed_plain(_u32(u1_bits).T != 0, _u32(u2_bits).T != 0,
                                 _lim13(qx), _lim13(qy), q_inf != 0,
                                 _lim13(r0), _lim13(rn), wrap_ok != 0)


def ecdsa_verify_batch_jit(u1_bits, u2_bits, qx, qy, q_inf, r0, rn, wrap_ok):
    """The bit-ladder verify on pack_records' planes (the reference's name
    and arguments): u1_bits, u2_bits (256, B) and qx, qy, r0, rn (20, B)
    int32 or uint32 words, q_inf and wrap_ok (B,) bool or uint8, one
    device. Returns ok (B,) bool on that device: CUDA tensors launch
    csrc/ladder_verify.cu (the verdict still in flight until read), CPU
    tensors run ladder_planes_plain; anything else, or a build or launch
    failure, raises KernelUnavailable."""
    B = qx.shape[1]
    dev = qx.device
    _check([u1_bits, u2_bits], dev, [(256, B)] * 2,
           (torch.int32, torch.uint32))
    _check([qx, qy, r0, rn], dev, [(JAX_N_LIMBS, B)] * 4,
           (torch.int32, torch.uint32))
    _check([q_inf, wrap_ok], dev, [(B,)] * 2, (torch.uint8, torch.bool))
    if dev.type == "cpu":
        return ladder_planes_plain(u1_bits, u2_bits, qx, qy, q_inf, r0, rn,
                                   wrap_ok)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no ladder kernel for device {dev}")
    inputs = [u1_bits.contiguous(), u2_bits.contiguous(), qx.contiguous(),
              qy.contiguous(), q_inf.to(torch.uint8).contiguous(),
              r0.contiguous(), rn.contiguous(),
              wrap_ok.to(torch.uint8).contiguous()]
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    fn = cuda_build.entry("ladder_verify", [ctypes.c_void_p] * 9
                          + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(*[t.data_ptr() for t in inputs], ok.data_ptr(), B,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("ladder_verify", rc)
    LAUNCHES["ladder_verify"] += 1
    LAUNCH_SHAPES[("ladder_verify", B)] = LAUNCH_SHAPES.get(
        ("ladder_verify", B), 0) + 1
    return ok.view(torch.bool)
