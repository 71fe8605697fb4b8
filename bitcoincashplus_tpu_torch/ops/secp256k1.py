"""Batch secp256k1 ECDSA verification with 4-bit windows (the w4 rung).

Port of the w4 part of the reference's ops/secp256k1.py. Two layers:

- **The kernel** (``csrc/w4_verify.cu``, CUDA C++ for sm_90a, built with
  nvcc at first use and bound with ctypes by ops/cuda_build.py). It
  replaces both Pallas w4 kernels of the JAX package:
  ``_verify_kernel_w4_3d`` (its
  ``pallas_call`` at bitcoincashplus_tpu/ops/secp256k1.py:912, behind
  ``ecdsa_verify_batch_pallas_w4_bytes``) through the entry
  ``w4_verify_bytes``, and ``_verify_kernel_w4`` (``pallas_call`` at
  :827, behind ``ecdsa_verify_batch_pallas_w4``) through the entry
  ``w4_verify_planes``. It is bound by integer multiply-adds (at most
  about 437,000 32-bit IMADs per verify; see the source note in the .cu
  file): a field core of PTX carry chains, the tables in shared memory,
  and a team of T threads per lane, T and the block size picked per
  bucket by ``W4_LAUNCH``.
- **The plain version**: the same verify in PyTorch tensor ops, used for
  tensors on the CPU (the tests) and as the yardstick the kernel is held
  against on the card. It carries field elements as (..., 16) int64
  tensors of 16-bit limbs (lanes first): torch has no usable uint32
  arithmetic on the CPU, and int64 leaves room for a whole schoolbook
  column sum. A field multiply is one broadcast limb product and one
  anti-diagonal sum, then a fold of 2^256 == 2^32 + 977 and four parallel
  carry rounds.

The wrappers ``ecdsa_verify_batch_pallas_w4_bytes`` and
``ecdsa_verify_batch_pallas_w4`` keep the reference's names, argument
order, shapes and ``(ok, degen)`` bool results. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises ``KernelUnavailable`` — it never falls back.

Both keep the reference's schedule (64 MSB-first windows, 4 doublings, the
G add before the Q add, the Q table built as in ``_w4_tables``), so the
degen plane — an H == 0 collision between finite points in a cheap add —
matches the JAX kernel lane for lane. Degen lanes carry garbage and are
re-verified on the host by the caller (ops/ecdsa_batch.BatchHandle).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.secp256k1 import G, P, point_add
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
LAUNCHES = {"w4_verify_bytes": 0, "w4_verify_planes": 0}
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
    """Per-device constant tensors: the bias, p, and the affine G table
    (row j = jG, row 0 unused)."""
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

# The launch shape per bucket: (most lanes, team size T, threads a block);
# the first row whose lane count covers B applies. T threads of a team
# verify one lane (1, 2 or 4; see the .cu file). Chosen from
# chip_smoke.py's timing of every compared shape at each T and block size
# on the H100 (PERF.md, K4/K5): the fastest T whose results were equal on
# every compare.
W4_LAUNCH = ((2048, 4, 128), (8192, 2, 64), (None, 1, 128))


def launch_shape(B: int) -> tuple:
    """(team size, threads a block) of a w4 launch of B lanes."""
    return next((team, block) for most, team, block in W4_LAUNCH
                if most is None or B <= most)


def _launch(name: str, inputs: list, B: int, team: int | None = None,
            block: int | None = None) -> tuple:
    """Launch one entry on the current stream: inputs are contiguous CUDA
    tensors; allocates and returns the (ok, degen) uint8 outputs. team and
    block default to launch_shape(B)."""
    if team is None:
        team, block = launch_shape(B)
    fn = cuda_build.entry(name, _ENTRY_ARGS)
    dev = inputs[0].device
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    degen = torch.empty(B, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*[t.data_ptr() for t in inputs], ok.data_ptr(), degen.data_ptr(),
            B, team, block, stream)
    cuda_build.check_launch(name, rc)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, B)] = LAUNCH_SHAPES.get((name, B), 0) + 1
    return ok, degen


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
    where the kernel is held against it)."""
    return w4_verify_plain(
        _expand_nibble_windows(u1m).T, _expand_nibble_windows(u2m).T,
        _expand_limb_cols(qxb), _expand_limb_cols(qyb), q_inf8 != 0,
        _expand_limb_cols(r0b), _expand_limb_cols(rnb), wrap8 != 0)


def w4_verify_planes_plain(u1w, u2w, qx, qy, q_inf, r0, rn, wrap_ok):
    """The plain version of ecdsa_verify_batch_pallas_w4, on the inputs'
    own device."""
    def u32(t):
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def lim(t):
        return _limbs13_to_port(u32(t))

    return w4_verify_plain(u32(u1w).T & 0xF, u32(u2w).T & 0xF, lim(qx),
                           lim(qy), q_inf != 0, lim(r0), lim(rn),
                           wrap_ok != 0)
