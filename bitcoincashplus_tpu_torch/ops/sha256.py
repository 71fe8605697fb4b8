"""SHA-256 word helpers for the nonce sweeps.

Port of the part of the reference's ops/sha256.py that the sweeps use:
byte swaps, host packing of header words and target limbs, and the
little-endian uint256 compare of CheckProofOfWork. The batch header
programs (K1, ``sha256d_headers_jit``) come with the headers/Merkle slice.

Every helper here works on Python ints and on int64 tensors holding
32-bit values (the port's plain form: CPU torch has no uint32 shifts,
adds or compares), and ``bswap32`` also on numpy uint32.
"""

from __future__ import annotations

import numpy as np


def bswap32(x):
    """Byte-swap each 32-bit value (wire LE <-> SHA BE word views)."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def digest_to_limbs(h8: list) -> list:
    """Reinterpret digest state words as little-endian uint256 limbs
    (arith_uint256 view): limb[j] = bswap32(h[j]), limb 7 most significant."""
    return [bswap32(h) for h in h8]


def le256(limbs: list, target_limbs: list):
    """Branchless lexicographic hash <= target over LE limbs —
    CheckProofOfWork's arith_uint256 compare (src/pow.cpp:~74), evaluated
    per lane from the most significant limb down."""
    le = limbs[0] <= target_limbs[0]
    for j in range(1, 8):
        l, t = limbs[j], target_limbs[j]
        le = (l < t) | ((l == t) & le)
    return le


def target_to_limbs_np(target: int) -> np.ndarray:
    """256-bit target -> 8 LE uint32 limbs for the on-device compare."""
    return np.array(
        [(target >> (32 * j)) & 0xFFFFFFFF for j in range(8)], dtype=np.uint32
    )


def bytes_to_words_np(data: np.ndarray) -> np.ndarray:
    """(..., 4k) uint8 byte array -> (..., k) uint32 BE words."""
    if data.dtype != np.uint8 or data.shape[-1] % 4:
        raise ValueError(f"need (..., 4k) uint8 bytes, got {data.dtype} "
                         f"{data.shape}")
    return (
        data.reshape(*data.shape[:-1], data.shape[-1] // 4, 4)
        .view(">u4")  # big-endian words, SHA's native view
        .squeeze(-1)
        .astype(np.uint32)
    )
