// The GLV split of secp256k1 scalars, for sm_90a: k == k1 + lambda k2
// (mod n) with |k1|, |k2| < 2^128, by exact lattice rounding, and its
// constants (beta of the endomorphism phi(x, y) = (beta x, y), the group
// order, the Barrett constants and the lattice basis). Shared by the GLV
// verify lane (glv_lane.cuh) and the Schnorr MSM's split prologue
// (msm.cu). Model: ops/secp256k1.glv_split_plain.

#pragma once

#include "secp256k1_core.cuh"

namespace {

// beta: phi(x, y) = (beta x, y) = lambda (x, y)
__constant__ u32 c_beta[8] = {0x719501eeu, 0xc1396c28u, 0x12f58995u, 0x9cf04975u,
                              0xac3434e9u, 0x6e64479eu, 0x657c0710u, 0x7ae96a2bu};
// The split's constants (little-endian 32-bit words): the group order n,
// (n + 1) / 2, the Barrett constants g1 = round(2^384 b2 / n) and
// g2 = round(2^384 (-b1) / n), and the lattice basis.
__constant__ u32 c_n[8] = {0xd0364141u, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u,
                           0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
__constant__ u32 c_half_n[8] = {0x681b20a1u, 0xdfe92f46u, 0x57a4501du, 0x5d576e73u,
                                0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
__constant__ u32 c_g1[8] = {0x45dbb031u, 0xe893209au, 0x71e8ca7fu, 0x3daa8a14u,
                            0x9284eb15u, 0xe86c90e4u, 0xa7d46bcdu, 0x3086d221u};
__constant__ u32 c_g2[8] = {0x8ac47f71u, 0x1571b4aeu, 0x9df506c6u, 0x221208acu,
                            0x0abfe4c4u, 0x6f547fa9u, 0x010e8828u, 0xe4437ed6u};
__constant__ u32 c_b2[4] = {0x9284eb15u, 0xe86c90e4u, 0xa7d46bcdu, 0x3086d221u};
__constant__ u32 c_minus_b1[4] = {0x0abfe4c3u, 0x6f547fa9u, 0x010e8828u, 0xe4437ed6u};
__constant__ u32 c_a1[4] = {0x9284eb15u, 0xe86c90e4u, 0xa7d46bcdu, 0x3086d221u};
__constant__ u32 c_a2[5] = {0x9d44cfd8u, 0x57c1108du, 0xa8e2f3f6u, 0x14ca50f7u, 0x00000001u};

// ---- the lattice split: exact multi-word integers (no reduction) ----------

// r = a * b, exact (NA + NB words).
template <int NA, int NB>
__device__ __forceinline__ void mul_words(u32* r, const u32* a, const u32* b) {
#pragma unroll
    for (int i = 0; i < NA + NB; i++) r[i] = 0u;
#pragma unroll
    for (int i = 0; i < NA; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NB; j++) {
            c += (uint64_t)a[i] * b[j] + r[i + j];  // < 2^64
            r[i + j] = (u32)c;
            c >>= 32;
        }
        r[i + NB] = (u32)c;
    }
}

// r = a - b over W words (r may alias a or b); returns a < b (r is then
// the wrapped complement).
template <int W>
__device__ __forceinline__ bool sub_words(u32* r, const u32* a, const u32* b) {
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; i++) {
        const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
        r[i] = (u32)v;
        borrow = v >> 63;
    }
    return borrow != 0;
}

// a >= b, a of W words, b of 8 words (zero-extended).
template <int W>
__device__ __forceinline__ bool ge_words(const u32* a, const u32* b) {
    bool gt = false, eq = true;
#pragma unroll
    for (int i = W - 1; i >= 0; i--) {
        const u32 bi = i < 8 ? b[i] : 0u;
        gt = gt || (eq && a[i] > bi);
        eq = eq && a[i] == bi;
    }
    return gt || eq;
}

// c = round(m k / n): c~ = floor(k g / 2^384) is c or c - 1 (g is within
// 1/2 of 2^384 m / n); e = m k - c~ n, and c = c~ + 1 exactly where e >= 0
// and 2e >= n, i.e. e >= (n + 1) / 2 (n is odd). c < 2^128 for every
// k < 2^256 (m < 2^128). Model: ops/secp256k1.glv_split_plain.
__device__ __forceinline__ void round_quot(u32 c[4], const u32 k[8], const u32* g,
                                           const u32* m) {
    u32 prod[16];
    mul_words<8, 8>(prod, k, g);
#pragma unroll
    for (int i = 0; i < 4; i++) c[i] = prod[12 + i];
    u32 t[12], cn[12];
    mul_words<8, 4>(t, k, m);
    mul_words<4, 8>(cn, c, c_n);
    const bool under = sub_words<12>(t, t, cn);
    u32 plus = (!under && ge_words<12>(t, c_half_n)) ? 1u : 0u;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        const u32 v = c[i] + plus;
        plus = v < plus ? 1u : 0u;
        c[i] = v;
    }
}

// k (8 words, any value below 2^256) -> |k1|, |k2| (4 words each) and
// their signs, k == (-1)^n1 |k1| + lambda (-1)^n2 |k2| (mod n): equal to
// glv_decompose(k mod n) (an exact split is unchanged by adding n, since
// the basis has determinant n).
__device__ __forceinline__ void glv_split(const u32 k[8], u32 m1[4], bool& n1, u32 m2[4],
                                          bool& n2) {
    u32 c1[4], c2[4];
    round_quot(c1, k, c_g1, c_b2);
    round_quot(c2, k, c_g2, c_minus_b1);
    // k1 = k - (c1 a1 + c2 a2): s < 2^258, nine words
    u32 s[9], t[9], kp[9], d[9], e[9];
    mul_words<4, 4>(t, c1, c_a1);
    t[8] = 0u;
    mul_words<4, 5>(s, c2, c_a2);
#pragma unroll
    for (int i = 0; i < 9; i++) kp[i] = i < 8 ? k[i] : 0u;
    uint64_t cy = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        cy += (uint64_t)s[i] + t[i];
        s[i] = (u32)cy;
        cy >>= 32;
    }
    n1 = sub_words<9>(d, kp, s);
    sub_words<9>(e, s, kp);
#pragma unroll
    for (int i = 0; i < 4; i++) m1[i] = n1 ? e[i] : d[i];
    // k2 = c1 (-b1) - c2 b2
    u32 p1[8], p2[8], d2[8], e2[8];
    mul_words<4, 4>(p1, c1, c_minus_b1);
    mul_words<4, 4>(p2, c2, c_b2);
    n2 = sub_words<8>(d2, p1, p2);
    sub_words<8>(e2, p2, p1);
#pragma unroll
    for (int i = 0; i < 4; i++) m2[i] = n2 ? e2[i] : d2[i];
}

// 32 big-endian bytes -> 8 little-endian words, not reduced.
__device__ __forceinline__ void be32_words(u32 w[8], const uint8_t* b) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint8_t* q = b + 4 * (7 - i);
        w[i] = ((u32)q[0] << 24) | ((u32)q[1] << 16) | ((u32)q[2] << 8) | (u32)q[3];
    }
}

}  // namespace
