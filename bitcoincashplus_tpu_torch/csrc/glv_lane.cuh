// The GLV verify lane shared by the kernels of glv_verify.cu (the
// carry-chain design) and glv_pair.cu (the pair design), for sm_90a: the
// split, the window and digit readers, the lane's schedule (glv_lane,
// generic over the team type), the lane's shared-memory slot, the bodies
// of both entries' kernels and their launch. glv_verify.cu's head note
// says what a lane computes and what bounds it.

#pragma once

#include "secp256k1_pair.cuh"


namespace {

constexpr int kQWords = 15 * 24;        // T1: j Q', j = 1..15, (X, Y, Z)
constexpr int kSplitWords = 16;         // |k1|, |k2| of u1, then of u2
constexpr int kSlotWords = kQWords + kSplitWords;
constexpr int kMaxBlock = 128;
constexpr int kMaxShared = 232448;      // the most dynamic shared memory a block may use
constexpr int kCombTooth = 512 * 8;     // words of one tooth of one comb table
constexpr int kCombTable = 16 * kCombTooth;

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

// ---- window and digit readers -----------------------------------------------

// MSB-first 4-bit windows of a 128-bit magnitude as 16 big-endian bytes
// (glv_verify's s1m / s2m rows).
struct BeNibbles {
    const uint8_t* row;
    __device__ __forceinline__ u32 operator()(int k) const {
        const u32 b = row[k >> 1];
        return (k & 1) ? (b & 15u) : (b >> 4);
    }
};

// The same windows of a magnitude as 4 little-endian words (the split of
// glv_dev_verify, in the lane's shared-memory slot).
struct WordNibbles {
    const u32* w;
    __device__ __forceinline__ u32 operator()(int k) const {
        const int j = 31 - k;  // the nibble's place from the least significant
        return (w[j >> 3] >> (4 * (j & 7))) & 15u;
    }
};

// A comb entry's 8 words from global memory, by the read-only path.
__device__ __forceinline__ void ldg_fe(u32 r[8], const u32* __restrict__ src) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// ---- the shared verify core -------------------------------------------------

// One lane, run by its team. win1 / win2: the Q and lambda Q windows;
// d1 / d2: the G and lambda G comb digits (16 little-endian bytes each)
// with their signs sg1 / sg2; qy: the sign-folded y; qtab: the lane's
// shared-memory slot (T1); comb: (3, 16, 512, 8) words (x, y, beta x).
// final_r as in w4_verify.cu.
// r = a * b by the team's own product (the pair design splits it over
// the pair; the carry-chain design's T threads each compute it whole).
template <int T>
__device__ __forceinline__ void fe_mul_team(const Team<T>&, u32 r[8], const u32 a[8],
                                            const u32 b[8]) {
    fe_mul(r, a, b);
}
template <int L>
__device__ __forceinline__ void fe_mul_team(const PairTeam<L>& tm, u32 r[8], const u32 a[8],
                                            const u32 b[8]) {
    fe_mul_pair(tm.mask, tm.t & 1u, r, a, b);
}

template <class TM, class W1, class W2, class R>
__device__ __forceinline__ void glv_lane(const TM& tm, const W1& win1, const W2& win2,
                                         const uint8_t* d1, const uint8_t* d2, u32 sg1, u32 sg2,
                                         bool ydiff, const u32 qx[8], const u32 qy[8],
                                         const R& final_r, u32* qtab,
                                         const u32* __restrict__ comb, uint8_t* ok_out,
                                         uint8_t* degen_out) {
    u32 X[8], Y[8], Z[8];
    fe_copy(X, qx);
    fe_copy(Y, qy);
    fe_set_small(Z, 1u);
    if (tm.t == 0) st_point(qtab, X, Y, Z);
    pt_double(tm, X, Y, Z);
    if (tm.t == 0) st_point(qtab + 24, X, Y, Z);
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
        pt_add_mixed(tm, X, Y, Z, qx, qy);
        if (tm.t == 0) st_point(qtab + 24 * (j - 1), X, Y, Z);
    }
    if constexpr (TeamSize<TM>::value > 1) __syncwarp(tm.mask);

    fe_set_small(X, 1u);
    fe_set_small(Y, 1u);
    fe_set_small(Z, 0u);
    bool inf = true;
    bool degen = false;
#pragma unroll 1
    for (int k = 0; k < 32; k++) {
        if (!inf) {
#pragma unroll 1
            for (int d = 0; d < 4; d++) pt_double(tm, X, Y, Z);
        }
#pragma unroll 1
        for (int s = 0; s < 2; s++) {  // the Q stream, then the lambda Q stream
            const u32 w = s ? win2(k) : win1(k);
            if (w == 0u) continue;
            const u32* q = qtab + 24 * (w - 1);
            u32 QX[8], QY[8], QZ[8];
            ld_fe(QX, q);
            ld_fe(QY, q + 8);
            ld_fe(QZ, q + 16);
            if (s) {
                u32 t[8];
                fe_mul_team(tm, t, c_beta, QX);
                fe_copy(QX, t);
                if (ydiff) {
                    fe_set_small(t, 0u);
                    fe_sub(t, t, QY);
                    fe_copy(QY, t);
                }
            }
            if (inf) {
                fe_copy(X, QX);
                fe_copy(Y, QY);
                fe_copy(Z, QZ);
                inf = false;
            } else {
                degen |= pt_add_full(tm, X, Y, Z, QX, QY, QZ);
            }
        }
    }

#pragma unroll 1
    for (int i = 0; i < 16; i++) {
#pragma unroll 1
        for (int s = 0; s < 2; s++) {  // the G stream, then the lambda G stream
            const u32 d = s ? d2[i] : d1[i];
            if (d == 0u) continue;
            const u32 at = (u32)i * kCombTooth + ((s ? sg2 : sg1) * 256u + d) * 8u;
            u32 gx[8], gy[8];
            ldg_fe(gx, comb + (s ? 2 * kCombTable : 0) + at);
            ldg_fe(gy, comb + kCombTable + at);
            if (inf) {
                fe_copy(X, gx);
                fe_copy(Y, gy);
                fe_set_small(Z, 1u);
                inf = false;
            } else {
                degen |= pt_add_mixed(tm, X, Y, Z, gx, gy);
            }
        }
    }

    u32 r0[8], rn[8], ZZ[8], t0[8], t1[8];
    bool wrap;
    final_r(r0, rn, wrap);
    level(tm, {Prod{ZZ, Z, nullptr}});
    level(tm, {Prod{t0, r0, ZZ}, Prod{t1, rn, ZZ}});
    const bool ok = fe_eq(X, t0) || (wrap && fe_eq(X, t1));
    if (tm.t == 0) {
        *ok_out = (uint8_t)(ok && !inf);
        *degen_out = (uint8_t)degen;
    }
}

// The lane's shared-memory slot and team; false (after writing ok = degen =
// 0) for a q_inf lane, which does no work.
template <class TM>
struct Lane {
    int lane;
    u32* slot;
    TM tm;
};

template <class TM>
__device__ __forceinline__ bool lane_of(Lane<TM>& ln, const TM& tm, int B,
                                        const uint8_t* __restrict__ qinf8, uint8_t* ok,
                                        uint8_t* degen) {
    extern __shared__ uint4 smem[];
    constexpr int T = TeamSize<TM>::value;
    const int slot = threadIdx.x / T;
    ln.lane = blockIdx.x * (blockDim.x / T) + slot;
    if (ln.lane >= B) return false;
    ln.slot = reinterpret_cast<u32*>(smem) + kSlotWords * slot;
    ln.tm = tm;
    if (qinf8[ln.lane]) {
        if (ln.tm.t == 0) {
            ok[ln.lane] = 0;
            degen[ln.lane] = 0;
        }
        return false;
    }
    return true;
}

#define GLV_DEV_PARAMS                                                                     \
    const uint8_t *__restrict__ u1m, const uint8_t *__restrict__ u2m,                      \
        const uint8_t *__restrict__ qxb, const uint8_t *__restrict__ qyb,                  \
        const uint8_t *__restrict__ qinf8, const uint8_t *__restrict__ r0b,                \
        const uint8_t *__restrict__ rnb, const uint8_t *__restrict__ wrap8,                \
        const u32 *__restrict__ comb, uint8_t *__restrict__ ok, uint8_t *__restrict__ degen, \
        int B
#define GLV_DEV_ARGS u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen, B
#define GLV_HOST_PARAMS                                                                    \
    const uint8_t *__restrict__ d1m, const uint8_t *__restrict__ d2m,                      \
        const uint8_t *__restrict__ sg1, const uint8_t *__restrict__ sg2,                  \
        const uint8_t *__restrict__ s1m, const uint8_t *__restrict__ s2m,                  \
        const uint8_t *__restrict__ ydiff8, const uint8_t *__restrict__ qxb,               \
        const uint8_t *__restrict__ qyb, const uint8_t *__restrict__ qinf8,                \
        const uint8_t *__restrict__ r0b, const uint8_t *__restrict__ rnb,                  \
        const uint8_t *__restrict__ wrap8, const u32 *__restrict__ comb,                   \
        uint8_t *__restrict__ ok, uint8_t *__restrict__ degen, int B
#define GLV_HOST_ARGS \
    d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen, B

// One lane of glv_dev_verify, run by the team `tm` of either design.
template <class TM>
__device__ __forceinline__ void glv_dev_lane(const TM& tm, GLV_DEV_PARAMS) {
    Lane<TM> ln;
    if (!lane_of(ln, tm, B, qinf8, ok, degen)) return;
    const int lane = ln.lane;
    u32* split = ln.slot + kQWords;
    bool na1, na2, nb1, nb2;
    if constexpr (IsPairTeam<TM>::value) {
        // the two splits side by side: thread h of a pair splits u1 (h = 0)
        // or u2 (h = 1); the team's threads 0 and 1 store them and send
        // their signs to the team
        const u32 h = ln.tm.t & 1u;
        u32 k[8], m1[4], m2[4];
        bool n1, n2;
        be32_words(k, (h ? u2m : u1m) + (size_t)lane * 32);
        glv_split(k, m1, n1, m2, n2);
        if (ln.tm.t < 2) {
#pragma unroll
            for (int i = 0; i < 4; i++) {
                split[8 * h + i] = m1[i];
                split[8 * h + 4 + i] = m2[i];
            }
        }
        constexpr int T = TeamSize<TM>::value;
        const u32 signs = (n1 ? 1u : 0u) | (n2 ? 2u : 0u);
        const u32 sa = __shfl_sync(ln.tm.mask, signs, 0, T);
        const u32 sb = __shfl_sync(ln.tm.mask, signs, 1, T);
        na1 = sa & 1u;
        na2 = sa & 2u;
        nb1 = sb & 1u;
        nb2 = sb & 2u;
    } else {
        u32 k[8], m1[4], m2[4];
        be32_words(k, u1m + (size_t)lane * 32);
        glv_split(k, m1, na1, m2, na2);
        if (ln.tm.t == 0) {
#pragma unroll
            for (int i = 0; i < 4; i++) {
                split[i] = m1[i];
                split[4 + i] = m2[i];
            }
        }
        be32_words(k, u2m + (size_t)lane * 32);
        glv_split(k, m1, nb1, m2, nb2);
        if (ln.tm.t == 0) {
#pragma unroll
            for (int i = 0; i < 4; i++) {
                split[8 + i] = m1[i];
                split[12 + i] = m2[i];
            }
        }
    }
    u32 qx[8], qy[8];
    fe_from_be32(qx, qxb + (size_t)lane * 32);
    fe_from_be32(qy, qyb + (size_t)lane * 32);
    if (nb1) {  // the first Q-stream sign, folded into qy
        u32 t[8];
        fe_set_small(t, 0u);
        fe_sub(t, t, qy);
        fe_copy(qy, t);
    }
    const auto final_r = [=](u32 r0[8], u32 rn[8], bool& wrap) {
        fe_from_be32(r0, r0b + (size_t)lane * 32);
        fe_from_be32(rn, rnb + (size_t)lane * 32);
        wrap = wrap8[lane] != 0;
    };
    // the split's words are read only after the table build's __syncwarp
    const uint8_t* digits = reinterpret_cast<const uint8_t*>(split);
    glv_lane(ln.tm, WordNibbles{split + 8}, WordNibbles{split + 12}, digits, digits + 16,
             na1 ? 1u : 0u, na2 ? 1u : 0u, nb1 != nb2, qx, qy, final_r, ln.slot, comb,
             ok + lane, degen + lane);
}

// One lane of glv_verify, run by the team `tm` of either design.
template <class TM>
__device__ __forceinline__ void glv_host_lane(const TM& tm, GLV_HOST_PARAMS) {
    Lane<TM> ln;
    if (!lane_of(ln, tm, B, qinf8, ok, degen)) return;
    const int lane = ln.lane;
    u32 qx[8], qy[8];
    fe_from_be32(qx, qxb + (size_t)lane * 32);
    fe_from_be32(qy, qyb + (size_t)lane * 32);  // sign already folded by the host
    const auto final_r = [=](u32 r0[8], u32 rn[8], bool& wrap) {
        fe_from_be32(r0, r0b + (size_t)lane * 32);
        fe_from_be32(rn, rnb + (size_t)lane * 32);
        wrap = wrap8[lane] != 0;
    };
    glv_lane(ln.tm, BeNibbles{s1m + (size_t)lane * 16}, BeNibbles{s2m + (size_t)lane * 16},
             d1m + (size_t)lane * 16, d2m + (size_t)lane * 16, sg1[lane] != 0 ? 1u : 0u,
             sg2[lane] != 0 ? 1u : 0u, ydiff8[lane] != 0, qx, qy, final_r, ln.slot, comb,
             ok + lane, degen + lane);
}

// Checks the block size and sets the dynamic shared memory of `kernel`;
// returns the bytes, or 0 when the launch shape is refused.
template <class K>
size_t prepare(K kernel, int team, int block) {
    if (block <= 0 || block > kMaxBlock || block % 32 != 0) return 0;
    const size_t bytes = sizeof(u32) * (size_t)kSlotWords * (block / team);
    if (bytes > (size_t)kMaxShared) return 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
        cudaSuccess)
        return 0;
    return bytes;
}

// Launches `kernel` with T threads a lane.
template <int T, class K, class... Args>
int launch(K kernel, int B, int block, cudaStream_t stream, Args... args) {
    const size_t bytes = prepare(kernel, T, block);
    if (!bytes) return (int)cudaErrorInvalidValue;
    const int lanes = block / T;
    kernel<<<(B + lanes - 1) / lanes, block, bytes, stream>>>(args..., B);
    return (int)cudaGetLastError();
}

}  // namespace
