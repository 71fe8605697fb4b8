"""secp256k1 — CPU reference implementation (Python ints).

Reference: src/secp256k1/ (secp256k1_ecdsa_verify at src/secp256k1.c:~340,
secp256k1_ecmult at ecmult_impl.h, group law in group_impl.h, RFC6979
nonces in secp256k1_nonce_function_rfc6979). This module is:
  (a) the correctness oracle for the TPU batch kernel (ops/secp256k1.py),
  (b) the scalar fallback path for non-batchable checks,
  (c) the wallet's signer.

Python ints make the field/scalar arithmetic exact and readable; this path
is never the block-validation hot loop (that's the TPU batch).
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional

# Curve: y^2 = x^3 + 7 over F_p
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

# Affine points as (x, y) tuples; None is the point at infinity.
G = (GX, GY)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def point_add(p1, p2):
    """Affine group law (group_impl.h secp256k1_gej_add_var semantics)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None  # inverses
        return point_double(p1)
    lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def point_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, P - 2, P) % P
    x3 = (lam * lam - 2 * x) % P
    return (x3, (lam * (x - x3) - y) % P)


def point_mul(k: int, pt):
    """Double-and-add (the constant-time wNAF machinery of ecmult_impl.h is
    irrelevant off the hot path; verification needs no side-channel armor)."""
    k %= N
    result = None
    addend = pt
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_double(addend)
        k >>= 1
    return result


def point_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


# ---- key / pubkey codecs (src/pubkey.cpp CPubKey) ----

def pubkey_serialize(pt, compressed: bool = True) -> bytes:
    x, y = pt
    if compressed:
        return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def pubkey_parse(data: bytes) -> Optional[tuple]:
    """CPubKey decompression — secp256k1_ec_pubkey_parse. Returns None for
    anything malformed or off-curve."""
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            return None
        y2 = (x * x * x + B) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            return None
        if (y & 1) != (data[0] & 1):
            y = P - y
        return (x, y)
    if len(data) == 65 and data[0] in (4, 6, 7):
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        if x >= P or y >= P:
            return None
        # hybrid forms (6/7) must have matching parity
        if data[0] in (6, 7) and (y & 1) != (data[0] & 1):
            return None
        pt = (x, y)
        return pt if is_on_curve(pt) else None
    return None


def privkey_to_pubkey(secret: int, compressed: bool = True) -> bytes:
    return pubkey_serialize(point_mul(secret, G), compressed)


# ---- ECDSA (secp256k1.c secp256k1_ecdsa_verify / _sign) ----

def ecdsa_verify(pubkey, r: int, s: int, e: int) -> bool:
    """Raw ECDSA verify: pubkey affine point, (r, s) signature scalars,
    e = message hash as integer. Matches secp256k1_ecdsa_sig_verify
    (ecdsa_impl.h): accepts any s in [1, n-1] (low-s policy is enforced at
    the script layer, not here — like the reference library)."""
    if pubkey is None or not (1 <= r < N) or not (1 <= s < N):
        return False
    w = pow(s, N - 2, N)
    u1 = e * w % N
    u2 = r * w % N
    pt = point_add(point_mul(u1, G), point_mul(u2, pubkey))
    if pt is None:
        return False
    # r == x_R mod n (x_R in [0, p); the x_R >= n wraparound folds in here)
    return (pt[0] - r) % N == 0


def ecdsa_sign(secret: int, e: int, nonce: Optional[int] = None) -> tuple[int, int]:
    """Returns (r, s) with low-s normalization (the reference signer's
    secp256k1_ecdsa_sig_sign + secp256k1_scalar_cond_negate)."""
    if nonce is None:
        nonce = rfc6979_nonce(secret, e)
    k = nonce
    pt = point_mul(k, G)
    r = pt[0] % N
    assert r != 0
    s = pow(k, N - 2, N) * (e + r * secret) % N
    assert s != 0
    if s > N // 2:
        s = N - s
    return r, s


def rfc6979_nonce(secret: int, e: int, extra: bytes = b"") -> int:
    """RFC6979 deterministic nonce (secp256k1_nonce_function_rfc6979),
    HMAC-SHA256 variant, as the reference library uses."""
    x = secret.to_bytes(32, "big")
    msg = (e % (1 << 256)).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + msg + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + msg + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        candidate = int.from_bytes(v, "big")
        if 1 <= candidate < N:
            return candidate
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# ---- Recoverable ECDSA (secp256k1 recovery module:
# secp256k1_ecdsa_sign_recoverable / secp256k1_ecdsa_recover) ----

def ecdsa_sign_recoverable(secret: int, e: int) -> tuple[int, int, int]:
    """Returns (r, s, recid) with low-s normalization. recid bit 0 is the
    parity of R.y (flipped when s is negated), bit 1 flags R.x >= n
    (secp256k1_ecdsa_sig_sign's recid computation)."""
    k = rfc6979_nonce(secret, e)
    pt = point_mul(k, G)
    x, y = pt
    r = x % N
    assert r != 0
    recid = (2 if x >= N else 0) | (y & 1)
    s = pow(k, N - 2, N) * (e + r * secret) % N
    assert s != 0
    if s > N // 2:
        s = N - s
        recid ^= 1
    return r, s, recid


def ecdsa_recover(r: int, s: int, recid: int, e: int):
    """Recover the signing pubkey point, or None (secp256k1_ecdsa_recover:
    Q = r^-1 (s·R − e·G) with R reconstructed from r/recid)."""
    if not (1 <= r < N) or not (1 <= s < N) or not (0 <= recid <= 3):
        return None
    x = r + (N if recid & 2 else 0)
    if x >= P:
        return None
    y2 = (x * x * x + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (recid & 1):
        y = P - y
    r_inv = pow(r, N - 2, N)
    q = point_add(point_mul(s * r_inv % N, (x, y)),
                  point_mul(-e * r_inv % N, G))
    return q


# ---- BCH Schnorr (2019-05 upgrade, spec 2019-05-15-schnorr.md) ----
#
# 64-byte (r || s) signatures over the SAME sighash digests as ECDSA,
# discriminated from DER by length at the script layer. Verification:
#   e = SHA256(r32 || ser_compressed(P) || m32) mod n
#   R = s·G + (n − e)·P;  accept iff R finite, jacobi(R.y) = 1, R.x = r
# This is the BCH rule set, NOT BIP340: the y-coordinate gate is the
# Jacobi symbol (not even-y), r is a full field element (no x-only
# pubkeys), and the challenge commits to the 33-byte COMPRESSED pubkey
# serialization regardless of how the key appeared on the stack.
# Schnorr is what makes TRUE batch verification possible (the batch MSM
# check in ops/secp256k1.py): unlike ECDSA, the verifier learns R itself
# (lifted from r), so N verifies collapse into one random-linear-
# combination multi-scalar multiplication.

def jacobi(a: int) -> int:
    """Jacobi symbol (a | p) via Euler's criterion (p prime): 1 for a
    quadratic residue, p − 1 (≡ −1) for a non-residue, 0 for 0."""
    return pow(a, (P - 1) // 2, P)


def schnorr_challenge(r: int, pubkey, msg_hash: int) -> int:
    """e = SHA256(r || ser(P) || m) mod n — the challenge scalar. Binds
    the compressed pubkey form so the same (r, s) can never be replayed
    against a different key encoding."""
    h = hashlib.sha256(
        r.to_bytes(32, "big")
        + pubkey_serialize(pubkey, compressed=True)
        + (msg_hash % (1 << 256)).to_bytes(32, "big")
    ).digest()
    return int.from_bytes(h, "big") % N


def schnorr_lift_x(r: int):
    """The affine point (r, y) with jacobi(y) = 1, or None when r³ + 7 is
    a non-residue (no such point exists, so no signature with this r can
    ever verify — the batch layer pre-rejects those host-side). p ≡ 3
    (mod 4), so the residue root is v^((p+1)/4); exactly one of {y, p−y}
    has Jacobi symbol 1 (p ≡ 3 mod 4 makes −1 a non-residue)."""
    if not (0 <= r < P):
        return None
    y2 = (r * r * r + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if jacobi(y) != 1:
        y = P - y
    return (r, y)


def schnorr_verify(pubkey, r: int, s: int, msg_hash: int) -> bool:
    """BCH Schnorr verify. Range rules per the spec: fail if r >= p or
    s >= n (r/s = 0 are in-range but can only verify if the algebra
    happens to — no special-case)."""
    if pubkey is None or not (0 <= r < P) or not (0 <= s < N):
        return False
    e = schnorr_challenge(r, pubkey, msg_hash)
    R = point_add(point_mul(s, G), point_mul(N - e, pubkey))
    if R is None:
        return False
    if jacobi(R[1]) != 1:
        return False
    return R[0] == r


def schnorr_sign(secret: int, msg_hash: int) -> tuple[int, int]:
    """Deterministic BCH Schnorr signer: RFC6979 nonce with the spec's
    "Schnorr+SHA256" additional data (verification never sees the nonce
    scheme, so any deterministic derivation interoperates). k is negated
    when jacobi(R.y) != 1 so the verifier's Jacobi gate holds; r is R.x
    as a FULL field element (may exceed n, unlike ECDSA's r)."""
    assert 1 <= secret < N
    k = rfc6979_nonce(secret, msg_hash, extra=b"Schnorr+SHA256  ")
    Rp = point_mul(k, G)
    if jacobi(Rp[1]) != 1:
        k = N - k
    r = Rp[0]
    e = schnorr_challenge(r, point_mul(secret, G), msg_hash)
    s = (k + e * secret) % N
    return r, s


# ---- DER (src/pubkey.cpp CPubKey::CheckLowS / ecdsa_signature_parse_der_lax) ----

def sig_der_encode(r: int, s: int) -> bytes:
    def enc_int(v: int) -> bytes:
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if b[0] & 0x80:
            b = b"\x00" + b
        return b"\x02" + bytes([len(b)]) + b

    body = enc_int(r) + enc_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _lax_len(sig: bytes, pos: int) -> Optional[tuple[int, int]]:
    """One BER length field at ``pos``: returns (length, new_pos) or None.
    Multi-byte (0x80-flagged) lengths are decoded after skipping leading
    zero bytes, exactly as ecdsa_signature_parse_der_lax does."""
    if pos >= len(sig):
        return None
    lenbyte = sig[pos]
    pos += 1
    if not lenbyte & 0x80:
        return lenbyte, pos
    lenbyte &= 0x7F
    if lenbyte > len(sig) - pos:
        return None
    while lenbyte > 0 and sig[pos] == 0:
        pos += 1
        lenbyte -= 1
    if lenbyte >= 8:  # sizeof(size_t) guard in the reference
        return None
    out = 0
    while lenbyte > 0:
        out = (out << 8) + sig[pos]
        pos += 1
        lenbyte -= 1
    return out, pos


def sig_der_decode(sig: bytes) -> Optional[tuple[int, int]]:
    """Permissive BER-ish parse mirroring ecdsa_signature_parse_der_lax
    (src/pubkey.cpp — the consensus behavior pre-BIP66 strictness; strict
    DER enforcement is a script-flag check done on the raw bytes, not here).

    Parity-critical details: an R/S length that overclaims the remaining
    input REJECTS (reference nodes fail the parse, so accepting it here
    would be a chain-split vector); an integer wider than 32 bytes after
    stripping leading zeros "overflows" and yields (0, 0) — a parse
    success whose verify then fails, matching the reference exactly."""
    if len(sig) < 2 or sig[0] != 0x30:
        return None
    got = _lax_len(sig, 1)
    if got is None:
        return None
    _seq_len, pos = got  # sequence length value is ignored (lax), bounds aren't

    def int_at(pos: int) -> Optional[tuple[int, int]]:
        if pos >= len(sig) or sig[pos] != 0x02:
            return None
        got = _lax_len(sig, pos + 1)
        if got is None:
            return None
        vlen, vpos = got
        if vlen > len(sig) - vpos:
            return None  # length exceeds input: reject, don't truncate
        start, end = vpos, vpos + vlen
        while start < end and sig[start] == 0:
            start += 1
        if end - start > 32:
            return -1, end  # overflow marker
        return int.from_bytes(sig[start:end], "big"), end

    got = int_at(pos)
    if got is None:
        return None
    r, pos = got
    got = int_at(pos)
    if got is None:
        return None
    s, _pos = got
    if r < 0 or s < 0:  # overflow: reference zeroes the whole signature
        return (0, 0)
    return (r, s)
