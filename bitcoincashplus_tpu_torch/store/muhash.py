"""MuHash-style multiplicative UTXO-set accumulator.

Reference: src/crypto/muhash.{h,cpp} (MuHash3072, BIP-UTXO set hashing)
and PAPERS.md 2407.03511 — the snapshot commitment is structured as an
incrementally-hashable accumulator so a succinct proof could later attest
the same digest the node maintains live.

The set hash of a multiset S of byte strings is

    H(S) = sha256( BE384( prod_{x in S} elem(x)  mod p ) )

with p = 2^3072 - 1103717 (the MuHash3072 prime) and elem(x) a hash-to-
group map (SHAKE256 expansion of x to 384 bytes, reduced mod p). The
group is (Z/pZ)*, so:

  - insertion multiplies the accumulator by elem(x);
  - removal multiplies by elem(x)^-1 (one modular inverse per batch —
    removed elements are multiplied together first);
  - the hash is order- and partition-independent: a sharded store keeps
    one accumulator per shard and the global digest is the product of the
    shard accumulators, identical for every shard count.

Two batch-product backends, differential-tested against each other:

  - `batch_product_ref`: plain python ints (CPython's native big-int
    multiply);
  - `_batch_product_limbs`: numpy 16-bit-limb rows (192 limbs, pairwise
    tree reduction with a shift-add schoolbook multiply — partial sums
    bounded by 192 * (2^16-1)^2 < 2^40, far under uint64 — a sequential
    carry sweep, and a fold-based reduction using 2^3072 ≡ 1103717
    mod p). The limb layout is the vector-unit-friendly form.

`batch_product` dispatches between them. Measured on the bench host
(single core), CPython's int multiply wins at every batch size — 22 µs
vs ~270 µs per element at 50k elements; the limb path's per-level python
loop over 192 limb positions dominates — so the int path is the default
and BCP_MUHASH_LIMBS=1 opts in to the limb backend. stdlib+numpy only —
importable from the jax-free crash-test workers.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable, Optional

try:
    import numpy as _np
except Exception:  # pragma: no cover - numpy is part of the baked image
    _np = None

# The MuHash3072 prime: 2^3072 - 1103717.
MUHASH_C = 1103717
MUHASH_P = (1 << 3072) - MUHASH_C

_ND = 192          # 3072 bits / 16-bit limbs
_LIMB_MASK = 0xFFFF

# p as little-endian 16-bit limbs, for the vectorized compare/subtract.
_P_LIMBS = None
if _np is not None:
    _P_LIMBS = _np.frombuffer(
        MUHASH_P.to_bytes(384, "little"), dtype="<u2"
    ).astype(_np.uint64)


def element(data: bytes) -> int:
    """Hash-to-group: SHAKE256(data) expanded to 384 bytes, reduced mod p.
    Never returns 0 (0 is not in the multiplicative group)."""
    v = int.from_bytes(hashlib.shake_256(data).digest(384), "little")
    v %= MUHASH_P
    return v if v else 1


def coin_element(key36: bytes, coin_ser: bytes) -> int:
    """The accumulator element for one UTXO row: outpoint key (32-byte
    txid + LE32 index) followed by the Coin serialization — exactly the
    bytes the sharded store persists, so a from-scratch recompute over
    `iterate_coins()` reproduces the live digest."""
    return element(key36 + coin_ser)


def digest_of(acc: int) -> bytes:
    """32-byte set digest of an accumulator value (big-endian 384-byte
    serialization, sha256'd)."""
    return hashlib.sha256((acc % MUHASH_P).to_bytes(384, "big")).digest()


# -- python-int reference path ---------------------------------------------

def batch_product_ref(values: Iterable[int]) -> int:
    acc = 1
    for v in values:
        acc = (acc * v) % MUHASH_P
    return acc


# -- numpy limb path -------------------------------------------------------

def _to_limbs(values: list[int]):
    rows = _np.empty((len(values), _ND), dtype=_np.uint64)
    for i, v in enumerate(values):
        rows[i] = _np.frombuffer(v.to_bytes(384, "little"), dtype="<u2")
    return rows


def _from_limbs(row) -> int:
    return int.from_bytes(row.astype("<u2").tobytes(), "little")


def _carry_sweep(acc):
    """Normalize partial sums to 16-bit limbs in place; returns acc."""
    carry = _np.zeros(acc.shape[0], dtype=_np.uint64)
    for j in range(acc.shape[1]):
        t = acc[:, j] + carry
        acc[:, j] = t & _LIMB_MASK
        carry = t >> 16
    assert not carry.any()  # columns sized so the top carry is always 0
    return acc


def _mul_pairs(xs, ys):
    """Schoolbook multiply of paired rows -> (B, 2*_ND + 1) limb rows.
    Each partial sum is <= 192 * (2^16-1)^2 < 2^40: no uint64 overflow."""
    n = xs.shape[0]
    acc = _np.zeros((n, 2 * _ND + 1), dtype=_np.uint64)
    for i in range(_ND):
        acc[:, i:i + _ND] += xs[:, i:i + 1] * ys
    return _carry_sweep(acc)


def _fold(rows):
    """One reduction fold: x = hi * 2^3072 + lo  ->  hi * c + lo  (mod p
    unchanged). Input (B, W) limbs with W > _ND; output (B, W') with
    W' < W. Repeating until W == _ND leaves values < 2^3072 + small."""
    lo = rows[:, :_ND]
    hi = rows[:, _ND:]
    w = hi.shape[1] + 2  # hi*c grows by at most 21 bits (< 2 limbs)
    acc = _np.zeros((rows.shape[0], max(w, _ND + 1)), dtype=_np.uint64)
    acc[:, :hi.shape[1]] = hi * MUHASH_C  # <= (2^16-1)*c < 2^37 per limb
    acc[:, :_ND] += lo
    return _carry_sweep(acc)


def _reduce_mod_p(rows):
    """Full reduction of (B, W) limb rows to canonical residues (B, _ND)."""
    while rows.shape[1] > _ND:
        folded = _fold(rows)
        # strip limbs that went to zero at the top so the loop terminates
        top = folded.shape[1]
        while top > _ND and not folded[:, top - 1].any():
            top -= 1
        rows = folded[:, :top]
    # rows < 2^3072 now; subtract p where rows >= p (at most once, since
    # 2^3072 < 2p). Vectorized big-endian compare, then borrow-subtract.
    gt_mask = _np.zeros(rows.shape[0], dtype=bool)
    lt_mask = _np.zeros(rows.shape[0], dtype=bool)
    for j in range(_ND - 1, -1, -1):
        undecided = ~(gt_mask | lt_mask)
        gt_mask |= undecided & (rows[:, j] > _P_LIMBS[j])
        lt_mask |= undecided & (rows[:, j] < _P_LIMBS[j])
    ge = ~lt_mask  # equal-all-the-way counts as >= p too
    if ge.any():
        sub = rows[ge]
        borrow = _np.zeros(sub.shape[0], dtype=_np.uint64)
        base = _np.uint64(1 << 16)
        for j in range(_ND):
            t = sub[:, j] + base - _P_LIMBS[j] - borrow
            sub[:, j] = t & _LIMB_MASK
            borrow = _np.uint64(1) - (t >> 16)
        rows[ge] = sub
    return rows


def _batch_product_limbs(values: list[int]) -> int:
    """prod(values) mod p via the numpy limb rows (pairwise tree
    reduction). Equal to :func:`batch_product_ref` always — the unit
    suite asserts it on random and near-p inputs."""
    rows = _reduce_mod_p(_to_limbs(values))
    while rows.shape[0] > 1:
        k = rows.shape[0] // 2
        prod = _reduce_mod_p(_mul_pairs(rows[0:2 * k:2], rows[1:2 * k:2]))
        if rows.shape[0] % 2:
            prod = _np.concatenate([prod, rows[-1:]], axis=0)
        rows = prod
    return _from_limbs(rows[0])


# Opt-in to the limb backend for the live accumulator. Default off: the
# int path measured faster at every batch size on the bench host (see
# module docstring; BENCH_r12.json records the commit-path numbers).
_USE_LIMBS = os.environ.get("BCP_MUHASH_LIMBS") == "1"


def batch_product(values: list[int]) -> int:
    """prod(values) mod p. Dispatches to the measured-faster python-int
    path unless BCP_MUHASH_LIMBS=1 forces the numpy limb backend (which
    also needs numpy present and a non-tiny batch)."""
    if _USE_LIMBS and _np is not None and len(values) >= 8:
        return _batch_product_limbs(values)
    return batch_product_ref(values)


class MuHash:
    """The incremental accumulator one store shard maintains.

    State is a single group element (identity 1 = empty set), serialized
    as 384 big-endian bytes in the shard's meta row. `apply` consumes one
    commit's delta: added/removed elements are tree-multiplied in batch
    and the removals cost exactly one modular inverse."""

    def __init__(self, state: int = 1):
        self.state = state % MUHASH_P

    @classmethod
    def from_bytes(cls, raw: Optional[bytes]) -> "MuHash":
        if not raw:
            return cls(1)
        return cls(int.from_bytes(raw, "big"))

    def to_bytes(self) -> bytes:
        return self.state.to_bytes(384, "big")

    def insert(self, data: bytes) -> None:
        self.state = (self.state * element(data)) % MUHASH_P

    def remove(self, data: bytes) -> None:
        self.state = (self.state * pow(element(data), -1, MUHASH_P)) % MUHASH_P

    def apply(self, added: list[int], removed: list[int]) -> None:
        """Batch delta: state *= prod(added) / prod(removed)."""
        if added:
            self.state = (self.state * batch_product(added)) % MUHASH_P
        if removed:
            inv = pow(batch_product(removed), -1, MUHASH_P)
            self.state = (self.state * inv) % MUHASH_P

    def digest(self) -> bytes:
        return digest_of(self.state)


def combine(states: Iterable[int]) -> int:
    """Global accumulator of a sharded store: the product of the per-shard
    states. Partition-independent — any shard count yields one digest."""
    return batch_product_ref(states)
