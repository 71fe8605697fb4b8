// The GLV verify lane shared by the kernels of glv_verify.cu (the
// carry-chain design) and glv_pair.cu (the pair design), for sm_90a: the
// window and digit readers, the lane's schedule (glv_lane, generic over
// the team type), the lane's shared-memory slot, the bodies of both
// entries' kernels and their launch (the split is glv_split.cuh's).
// glv_verify.cu's head note says what a lane computes and what bounds it.

#pragma once

#include "glv_split.cuh"
#include "secp256k1_pair.cuh"

namespace {

constexpr int kQWords = 15 * 24;        // T1: j Q', j = 1..15, (X, Y, Z)
constexpr int kSplitWords = 16;         // |k1|, |k2| of u1, then of u2
constexpr int kSlotWords = kQWords + kSplitWords;
constexpr int kMaxBlock = 128;
constexpr int kMaxShared = 232448;      // the most dynamic shared memory a block may use
constexpr int kCombTooth = 512 * 8;     // words of one tooth of one comb table
constexpr int kCombTable = 16 * kCombTooth;

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
