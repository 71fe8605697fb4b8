// The Schnorr batch check for sm_90a: a Pippenger multi-scalar
// multiplication sum_j k_j Q_j over secp256k1, on the GLV halves of the
// terms, with 4-bit windows.
//
// Replaces, in the JAX package (bitcoincashplus_tpu/ops/secp256k1.py),
// the XLA programs _msm_program (:1967, the verdict "is the sum the point
// at infinity") and _msm_partial_program (:1977, the sum itself), both
// through _msm_accumulate (:1843) with the complete adds pt_add_full
// (:1808) and pt_add_mixed (:418). Behind ops/secp256k1.py's
// schnorr_msm_is_infinity and msm_partial_point (entry msm_run, which
// enqueues the kernels below; msm_split, msm_buckets, msm_merge,
// msm_reduce and msm_combine are entries of their own so that each can be
// timed alone).
//
// Inputs, as the JAX program's: xm, ym, km (M, 32) big-endian bytes (the
// affine terms and their scalars, k < n) and inf8 (M,) (a flagged term
// adds nothing). Only the sum is the contract (the verdict, and the point
// that the sharded path folds on the host), so the schedule is this
// kernel's own, not the JAX program's; the plain version
// (ops/secp256k1.msm_accumulate_plain) runs the same schedule, so the
// sum's Jacobian triple, and not only its affine point, is the plain
// version's:
//
//   msm_split: one thread a term. k_j == k1 + lambda k2 (mod n) with
//     |k1|, |k2| < 2^128 (glv_split.cuh); term j becomes the two terms
//     j = (|k1|, +-Q_j) and M + j = (|k2|, +-phi(Q_j)), phi(x, y) =
//     (beta x, y) = lambda Q_j, y negated where the half is negative.
//     2M terms of 24 words (x, y, the 128-bit magnitude, the flag).
//   msm_buckets: K streams of S = 2M / K terms (K a power of two, at most
//     512: S = 32 at the buckets 64 .. 8192, 64 at 16384); one team a
//     (stream k, window w) lane (a team of 4, or 2 from 8,192 lanes up),
//     lane = 32 k + w, 32 K lanes. Lane w of stream k walks its stream's
//     terms in order and adds each term whose digit (the w-th 4-bit
//     window of its magnitude, MSB first) is not 0 into bucket digit of
//     its 15 buckets by a complete mixed add.
//   msm_merge: one launch a level, K/2, K/4, .. 1 streams: bucket b of
//     window w of stream j (j < half) += the same bucket of stream j +
//     half, a complete full add, the lower stream first.
//   msm_reduce: a block of 16 teams a window. sum_b b B_b = sum_i 2^i T_i,
//     T_i the sum of the 8 buckets whose bit i is set: four 8-bucket add
//     trees side by side (pairs in increasing b, then the lower pair
//     first), then 2 T3 + T2 and 2 T1 + T0 side by side, then
//     4 (2 T3 + T2) + (2 T1 + T0): 3 + 2 adds and 3 doublings deep.
//   msm_combine: a block of 16 teams: the 32 window sums (window 0 the
//     most significant) joined in a tree, level l (l = 0 .. 4) taking
//     groups A, B of 2^l windows to 2^(4 2^l) A + B: 124 doublings and 5
//     adds deep. It writes 25 words: the canonical X, Y, Z (8
//     little-endian words each; X = Y = 1, Z = 0 at infinity) and the
//     infinity flag.
//
// The buckets live in global memory (scratch the wrapper allocates: 15
// buckets x 25 words a lane, word-major with the lane fastest, so that
// neighbouring lanes touch neighbouring words): a bucket is picked by a
// runtime digit, and a per-thread array indexed that way would fall into
// local memory. 16,384 lanes (M = 8192 and 16384) take 24.6 MB, half the
// 50 MB L2: 1,024 streams (S = 32 at M = 16384) would take 49 MB, and the
// walk's loads and stores would miss in L2.
//
// Complete adds throughout (secp256k1_complete.cuh): an adversary picks
// the R_i and P_i of a batch, so a bucket, a merge, the reduction or the
// combination can meet P == Q or P == -Q, and one wrong add could turn a
// forged batch into an accepting infinity. There is no host re-check of a
// lane here.
//
// What bounds it on an H100. The work is integer multiply-adds (a field
// product is 146 IMADs, a square 90; a complete mixed add 3 squares and 8
// products, 1,438 IMADs): at M = 16384 about 10^6 mixed adds, 1.4 G
// IMADs, 0.09 ms at the card's 64 IMADs a clock on 132 SMs. But the
// launch is bound by latency: the longest chain of dependent field
// products. A team of 4 threads a lane (Team<4> of secp256k1_core.cuh)
// spreads each level of independent products over its threads (a
// complete add is 6 levels, a doubling 3). The design keeps that chain
// short: the GLV split halves the doublings of the combination (124, not
// 252); the window sums join in a log-depth tree (5 adds, not 64); the
// weighted bucket sums run as 16 teams a window (about 39 levels, not the
// suffix sums' 180); the stream count grows with M so that no lane walks
// more than 32 terms up to M = 8192 (64 at 16384, where the walk's time is
// its IMADs and its memory, not its chain). At 4,096 terms the chain is
// about 680 levels (the suffix-sum and Horner schedule: about 1,500).

#include <cstdint>
#include <cuda_runtime.h>

#include "glv_split.cuh"
#include "secp256k1_complete.cuh"

namespace {

constexpr int kThreads = 128;
// threads a team (a lane): each level of independent products is spread
// over them (secp256k1_core.cuh's level<4, N>)
constexpr int kTeam = 4;
using TeamT = Team<kTeam>;
// From this many lanes (M = 4096 and up) the walk and the merges run
// teams of 2: with a wave or more of lanes their time is the IMADs a lane
// issues (a team of 4 computes a level of one product four times), not
// the chain, and a team of 2 issues about 40% fewer for a mixed add.
// Below it the chain rules and teams of 4 win. `chip_smoke.py
// --msm-teams` builds this file with -DMSM_WALK_TEAM=2 and =4 (one team
// at every size) and times msm_run at every bucket: on an H100 80GB HBM3
// at 700 W, teams of 4 were 5% faster at 64 .. 1,024 terms (128 .. 2,048
// lanes), teams of 2 5%, 18% and 24% faster at 4,096, 8,192 and 16,384.
constexpr int kWideLanes = 8192;
constexpr int kWideTeam = 2;

#ifdef MSM_WALK_TEAM
inline bool wide(int) { return MSM_WALK_TEAM == kWideTeam; }
#else
inline bool wide(int lanes) { return lanes >= kWideLanes; }
#endif
constexpr int kWords = 25;      // X, Y, Z (8 words each) and the inf flag
constexpr int kBuckets = 15;    // digits 1 .. 15 (bucket b - 1)
constexpr int kWindows = 32;    // 4-bit windows of a 128-bit magnitude
constexpr int kTermWords = 24;  // x, y (8 words each), |k| (4), flag, pad
constexpr int kMaxStreams = 512;
constexpr int kTreeTeams = 16;  // teams of the reduction and the combination

__device__ __forceinline__ void ld_bucket(const u32* bk, int stride, int b, int lane, u32 X[8],
                                          u32 Y[8], u32 Z[8], bool& inf) {
    const u32* p = bk + (size_t)b * kWords * stride + lane;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        X[i] = p[(size_t)i * stride];
        Y[i] = p[(size_t)(8 + i) * stride];
        Z[i] = p[(size_t)(16 + i) * stride];
    }
    inf = p[(size_t)24 * stride] != 0u;
}

// Every thread of a team stores the same words: a thread later reads its
// own store or its teammates' equal one.
__device__ __forceinline__ void st_bucket(u32* bk, int stride, int b, int lane, const u32 X[8],
                                          const u32 Y[8], const u32 Z[8], bool inf) {
    u32* p = bk + (size_t)b * kWords * stride + lane;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        p[(size_t)i * stride] = X[i];
        p[(size_t)(8 + i) * stride] = Y[i];
        p[(size_t)(16 + i) * stride] = Z[i];
    }
    p[(size_t)24 * stride] = inf ? 1u : 0u;
}

// A point as 25 consecutive words (shared memory or the window sums).
__device__ __forceinline__ void ld_point(const u32* s, u32 X[8], u32 Y[8], u32 Z[8], bool& inf) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        X[i] = s[i];
        Y[i] = s[8 + i];
        Z[i] = s[16 + i];
    }
    inf = s[24] != 0u;
}

__device__ __forceinline__ void st_point25(u32* d, const u32 X[8], const u32 Y[8], const u32 Z[8],
                                           bool inf) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        d[i] = X[i];
        d[8 + i] = Y[i];
        d[16 + i] = Z[i];
    }
    d[24] = inf ? 1u : 0u;
}

// 8 words of a term, by the read-only path
__device__ __forceinline__ void ldg8(u32 r[8], const u32* __restrict__ src) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void dbl_times(const TeamT& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                          bool inf, int times) {
    if (inf) return;  // infinity doubles to itself
    for (int r = 0; r < times; r++) pt_double(tm, X, Y, Z);
}

__device__ __forceinline__ void st_term(u32* dst, const u32 x[8], const u32 y[8],
                                        const u32 k[4], u32 flag) {
    uint4* t = reinterpret_cast<uint4*>(dst);
    t[0] = make_uint4(x[0], x[1], x[2], x[3]);
    t[1] = make_uint4(x[4], x[5], x[6], x[7]);
    t[2] = make_uint4(y[0], y[1], y[2], y[3]);
    t[3] = make_uint4(y[4], y[5], y[6], y[7]);
    t[4] = make_uint4(k[0], k[1], k[2], k[3]);
    t[5] = make_uint4(flag, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
msm_split_kernel(const uint8_t* __restrict__ xm, const uint8_t* __restrict__ ym,
                 const uint8_t* __restrict__ inf8, const uint8_t* __restrict__ km,
                 u32* __restrict__ terms, int M) {
    const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    if (j >= M) return;
    u32 k[8], m1[4], m2[4], x[8], y[8], bx[8], ny[8], zero[8];
    bool n1, n2;
    be32_words(k, km + (size_t)j * 32);
    glv_split(k, m1, n1, m2, n2);
    fe_from_be32(x, xm + (size_t)j * 32);
    fe_from_be32(y, ym + (size_t)j * 32);
    fe_mul(bx, c_beta, x);
    fe_set_small(zero, 0u);
    fe_sub(ny, zero, y);
    const u32 flag = inf8[j] != 0 ? 1u : 0u;
    // word-wise selects: a runtime choice between register arrays by
    // pointer would put them in local memory
    u32 y1[8], y2[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        y1[i] = n1 ? ny[i] : y[i];
        y2[i] = n2 ? ny[i] : y[i];
    }
    st_term(terms + (size_t)j * kTermWords, x, y1, m1, flag);
    st_term(terms + (size_t)(M + j) * kTermWords, bx, y2, m2, flag);
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
msm_buckets_kernel(const u32* __restrict__ terms, u32* bk, int steps, int lanes) {
    const Team<T> tm = make_team<T>();
    const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / T);
    if (lane >= lanes) return;
    const int k = lane >> 5, w = lane & 31;
    const int pos = kWindows - 1 - w;  // the window's place from the least significant
    for (int b = 0; b < kBuckets; b++) bk[(size_t)(b * kWords + 24) * lanes + lane] = 1u;
    for (int s = 0; s < steps; s++) {
        const u32* term = terms + (size_t)(k * steps + s) * kTermWords;
        const uint4 kk = __ldg(reinterpret_cast<const uint4*>(term) + 4);
        const uint4 fl = __ldg(reinterpret_cast<const uint4*>(term) + 5);
        if (fl.x) continue;
        const u32 word = (pos >> 3) == 0 ? kk.x : (pos >> 3) == 1 ? kk.y
                         : (pos >> 3) == 2 ? kk.z : kk.w;
        const int d = (int)((word >> (4 * (pos & 7))) & 15u);
        if (d == 0) continue;
        u32 qx[8], qy[8], X[8], Y[8], Z[8];
        bool inf;
        ldg8(qx, term);
        ldg8(qy, term + 8);
        ld_bucket(bk, lanes, d - 1, lane, X, Y, Z, inf);
        pt_add_mixed_complete(tm, X, Y, Z, inf, qx, qy, false);
        st_bucket(bk, lanes, d - 1, lane, X, Y, Z, inf);
    }
}

// One merge level: items (j, b, w), j < half, b = 0 .. 14, w fastest.
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
msm_merge_kernel(u32* bk, int half, int lanes) {
    const Team<T> tm = make_team<T>();
    const int item = (int)((blockIdx.x * blockDim.x + threadIdx.x) / T);
    if (item >= half * kBuckets * kWindows) return;
    const int w = item & 31, jb = item >> 5;
    const int j = jb / kBuckets, b = jb % kBuckets;
    const int lo = j * kWindows + w, hi = (j + half) * kWindows + w;
    u32 X[8], Y[8], Z[8], X2[8], Y2[8], Z2[8];
    bool inf, inf2;
    ld_bucket(bk, lanes, b, lo, X, Y, Z, inf);
    ld_bucket(bk, lanes, b, hi, X2, Y2, Z2, inf2);
    pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
    st_bucket(bk, lanes, b, lo, X, Y, Z, inf);
}

// slot (i, p): the p-th pair, then subtree, of the buckets whose bit i is
// set (team q = 4 i + p)
__global__ void __launch_bounds__(kTreeTeams * kTeam, 1)
msm_reduce_kernel(const u32* __restrict__ bk, int lanes, u32* __restrict__ ws) {
    __shared__ __align__(16) u32 slot[kTreeTeams * kWords];
    const TeamT tm = make_team<kTeam>();
    const int w = (int)blockIdx.x;  // stream 0's lane w holds window w
    const int q = (int)(threadIdx.x / kTeam), i = q >> 2, p = q & 3;
    u32 X[8], Y[8], Z[8], X2[8], Y2[8], Z2[8];
    bool inf, inf2;
    {
        // the (2p)-th and (2p + 1)-th of the digits 1 .. 15 whose bit i is
        // set: r -> (r >> i) << (i + 1) | 1 << i | (r & (2^i - 1))
        const int lowmask = (1 << i) - 1;
        const int r0 = 2 * p, r1 = 2 * p + 1;
        const int b0 = ((r0 >> i) << (i + 1)) | (1 << i) | (r0 & lowmask);
        const int b1 = ((r1 >> i) << (i + 1)) | (1 << i) | (r1 & lowmask);
        ld_bucket(bk, lanes, b0 - 1, w, X, Y, Z, inf);
        ld_bucket(bk, lanes, b1 - 1, w, X2, Y2, Z2, inf2);
        pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
        if (tm.t == 0) st_point25(slot + q * kWords, X, Y, Z, inf);
    }
    __syncthreads();
    for (int step = 1; step <= 2; step++) {  // pairs 2p += 2p + 1, then 0 += 2
        const bool on = (p & ((2 << (step - 1)) - 1)) == 0;
        if (on) {
            ld_point(slot + q * kWords, X, Y, Z, inf);
            ld_point(slot + (q + step) * kWords, X2, Y2, Z2, inf2);
            pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
        }
        __syncthreads();
        if (on && tm.t == 0) st_point25(slot + q * kWords, X, Y, Z, inf);
        __syncthreads();
    }
    // team 0: C1 = 2 T3 + T2 (into slot 12); team 1: C0 = 2 T1 + T0 (slot 4)
    if (q < 2) {
        const int hi = q == 0 ? 12 : 4, lo = q == 0 ? 8 : 0;
        ld_point(slot + hi * kWords, X, Y, Z, inf);
        ld_point(slot + lo * kWords, X2, Y2, Z2, inf2);
        dbl_times(tm, X, Y, Z, inf, 1);
        pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
    }
    __syncthreads();
    if (q < 2 && tm.t == 0) st_point25(slot + (q == 0 ? 12 : 4) * kWords, X, Y, Z, inf);
    __syncthreads();
    if (q == 0) {  // the window's sum: 4 C1 + C0
        ld_point(slot + 12 * kWords, X, Y, Z, inf);
        ld_point(slot + 4 * kWords, X2, Y2, Z2, inf2);
        dbl_times(tm, X, Y, Z, inf, 2);
        pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
        if (tm.t == 0) st_point25(ws + w * kWords, X, Y, Z, inf);
    }
}

__global__ void __launch_bounds__(kTreeTeams * kTeam, 1)
msm_combine_kernel(const u32* __restrict__ ws, u32* __restrict__ out) {
    __shared__ __align__(16) u32 s[kWindows * kWords];
    const TeamT tm = make_team<kTeam>();
    const int q = (int)(threadIdx.x / kTeam);
    for (int i = (int)threadIdx.x; i < kWindows * kWords; i += (int)blockDim.x) s[i] = ws[i];
    __syncthreads();
    u32 X[8], Y[8], Z[8], X2[8], Y2[8], Z2[8];
    bool inf, inf2;
    for (int l = 0; l < 5; l++) {
        const int stride = 1 << l;
        const bool on = q < (kTreeTeams >> l);
        const int a = 2 * stride * q;
        if (on) {
            ld_point(s + a * kWords, X, Y, Z, inf);
            ld_point(s + (a + stride) * kWords, X2, Y2, Z2, inf2);
            dbl_times(tm, X, Y, Z, inf, 4 * stride);  // 2^(4 stride) A
            pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
        }
        __syncthreads();
        if (on && tm.t == 0) st_point25(s + a * kWords, X, Y, Z, inf);
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        ld_point(s, X, Y, Z, inf);
        if (inf) {
            fe_set_small(X, 1u);
            fe_set_small(Y, 1u);
            fe_set_small(Z, 0u);
        }
        fe_canon(X2, X);
        fe_canon(Y2, Y);
        fe_canon(Z2, Z);
        st_point25(out, X2, Y2, Z2, inf);
    }
}

inline unsigned blocks(long long threads) {
    return (unsigned)((threads + kThreads - 1) / kThreads);
}

// K streams of 2M / K terms each: K a power of two, at most kMaxStreams
bool bad_shape(int M, int K) {
    return K < 1 || K > kMaxStreams || (K & (K - 1)) != 0 || M <= 0 || (2 * M) % K != 0;
}

}  // namespace

// terms: scratch of 24 x 2M words.
extern "C" int msm_split(const uint8_t* xm, const uint8_t* ym, const uint8_t* inf8,
                         const uint8_t* km, u32* terms, int M, void* stream) {
    if (M <= 0) return (int)cudaErrorInvalidValue;
    msm_split_kernel<<<blocks(M), kThreads, 0, (cudaStream_t)stream>>>(xm, ym, inf8, km, terms,
                                                                       M);
    return (int)cudaGetLastError();
}

// bk: scratch of 15 x 25 x (32 K) words; every bucket's flag is set to
// infinity here before the walk.
extern "C" int msm_buckets(const u32* terms, u32* bk, int M, int K, void* stream) {
    if (bad_shape(M, K)) return (int)cudaErrorInvalidValue;
    const int lanes = K * kWindows;
    if (wide(lanes))
        msm_buckets_kernel<kWideTeam><<<blocks((long long)kWideTeam * lanes), kThreads, 0,
                                        (cudaStream_t)stream>>>(terms, bk, 2 * M / K, lanes);
    else
        msm_buckets_kernel<kTeam><<<blocks((long long)kTeam * lanes), kThreads, 0,
                                    (cudaStream_t)stream>>>(terms, bk, 2 * M / K, lanes);
    return (int)cudaGetLastError();
}

// One merge level: streams [0, half) += streams [half, 2 half).
extern "C" int msm_merge(u32* bk, int K, int half, void* stream) {
    if (bad_shape(K, K) || half < 1 || 2 * half > K) return (int)cudaErrorInvalidValue;
    const long long items = (long long)half * kBuckets * kWindows;
    const int lanes = K * kWindows;
    if (wide(lanes))
        msm_merge_kernel<kWideTeam><<<blocks(kWideTeam * items), kThreads, 0,
                                      (cudaStream_t)stream>>>(bk, half, lanes);
    else
        msm_merge_kernel<kTeam><<<blocks(kTeam * items), kThreads, 0, (cudaStream_t)stream>>>(
            bk, half, lanes);
    return (int)cudaGetLastError();
}

// ws: the 32 window sums, 25 words each.
extern "C" int msm_reduce(const u32* bk, int K, u32* ws, void* stream) {
    if (bad_shape(K, K)) return (int)cudaErrorInvalidValue;
    msm_reduce_kernel<<<kWindows, kTreeTeams * kTeam, 0, (cudaStream_t)stream>>>(
        bk, K * kWindows, ws);
    return (int)cudaGetLastError();
}

// out: 25 words (X, Y, Z canonical, then the inf flag).
extern "C" int msm_combine(const u32* ws, u32* out, void* stream) {
    msm_combine_kernel<<<1, kTreeTeams * kTeam, 0, (cudaStream_t)stream>>>(ws, out);
    return (int)cudaGetLastError();
}

// The whole MSM: the split, the bucket walk, log2 K merge levels, the
// reduction, the combination.
extern "C" int msm_run(const uint8_t* xm, const uint8_t* ym, const uint8_t* inf8,
                       const uint8_t* km, u32* terms, u32* bk, u32* ws, u32* out, int M, int K,
                       void* stream) {
    if (bad_shape(M, K)) return (int)cudaErrorInvalidValue;
    int rc = msm_split(xm, ym, inf8, km, terms, M, stream);
    if (rc == 0) rc = msm_buckets(terms, bk, M, K, stream);
    for (int half = K / 2; rc == 0 && half >= 1; half /= 2) rc = msm_merge(bk, K, half, stream);
    if (rc == 0) rc = msm_reduce(bk, K, ws, stream);
    if (rc == 0) rc = msm_combine(ws, out, stream);
    return rc;
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
