// The Schnorr batch check for sm_90a: a Pippenger multi-scalar
// multiplication sum_j k_j Q_j over secp256k1 with 4-bit windows.
//
// Replaces, in the JAX package (bitcoincashplus_tpu/ops/secp256k1.py),
// the XLA programs _msm_program (:1967, the verdict "is the sum the point
// at infinity") and _msm_partial_program (:1977, the sum itself), both
// through _msm_accumulate (:1843) with the complete adds pt_add_full
// (:1808) and pt_add_mixed (:418). Behind ops/secp256k1.py's
// schnorr_msm_is_infinity and msm_partial_point (entry msm_run, which
// enqueues the three kernels below; msm_buckets, msm_merge and msm_tail
// are entries of their own so that each can be timed alone).
//
// Inputs, as the JAX program's: xm, ym, km (M, 32) big-endian bytes (the
// affine terms and their scalars, k < n) and inf8 (M,) (a flagged term
// adds nothing). M is a multiple of the stream count K = max(1, min(128,
// M / 32)) (the host pads to the buckets 64 .. 16384, multiples of every
// admissible K). The schedule is the JAX program's, and the plain
// version (ops/secp256k1.msm_accumulate_plain) runs it too, so the sum's
// Jacobian triple, and not only its affine point, is the plain version's:
//
//   msm_buckets: one team a (stream k, window w) lane, lane = 64 k + w,
//     K x 64 lanes. Stream k owns the terms k M/K .. (k + 1) M/K - 1;
//     its lane w walks them in order and adds each term whose digit (the
//     w-th 4-bit window of k_j, MSB first) is not 0 into bucket digit of
//     its 16 buckets by a complete mixed add. Bucket 0 is never written.
//   msm_merge: one launch a level, K/2, K/4, .. 1 streams: bucket b of
//     window w of stream j (j < half) += the same bucket of stream j +
//     half, a complete full add, the lower stream first.
//   msm_tail: a block of 64 teams; team w reduces its window's buckets
//     by the suffix sums (running += B_b; total += running, b = 15 .. 1:
//     total = sum_b b B_b), the totals meet in shared memory, and team 0
//     runs the Horner pass over the 64 window sums, MSB first (4
//     doublings, then a complete full add). It writes 25 words: the
//     canonical X, Y, Z (8 little-endian words each; X = Y = 1, Z = 0 at
//     infinity) and the infinity flag.
//
// The buckets live in global memory (scratch the wrapper allocates: 16
// buckets x 25 words a lane, word-major with the lane fastest, so that
// neighbouring lanes touch neighbouring words): a bucket is picked by a
// runtime digit, and a per-thread array indexed that way would fall into
// local memory. 8192 lanes at M = 16384 take 13 MB, which L2 holds.
//
// Complete adds throughout (secp256k1_complete.cuh): an adversary picks
// the R_i and P_i of a batch, so a bucket, a merge or the tail can meet
// P == Q or P == -Q, and one wrong add could turn a forged batch into an
// accepting infinity. There is no host re-check of a lane here.
//
// What bounds it on an H100. The work is integer multiply-adds (a field
// product is 146 IMADs, a square 90; a complete mixed add 3 squares and 8
// products, 1,438 IMADs): at M = 16384 about 10^6 mixed adds, 1.5 G
// IMADs, 0.09 ms at the card's 64 IMADs a clock on 132 SMs. But the
// launch is bound by latency: the longest dependent chain is M/K
// mixed adds in a lane, log2 K merges, 30 adds of the reduction and the
// Horner pass (256 doublings, 64 adds). A team of 4 threads a lane
// (Team<4> of secp256k1_core.cuh) spreads each level of independent
// products over its threads, which shortens that chain to its levels (a
// complete add is 6, a doubling 3); the Horner pass is one team. A team
// of one thread a lane was slower at every bucket on the H100, and
// its tail spilled.

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_complete.cuh"

namespace {

constexpr int kThreads = 128;
// threads a team (a lane): each level of independent products is spread
// over them (secp256k1_core.cuh's level<4, N>)
constexpr int kTeam = 4;
using TeamT = Team<kTeam>;
constexpr int kWords = 25;  // X, Y, Z (8 words each) and the inf flag

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

__global__ void __launch_bounds__(kThreads, 1)
msm_buckets_kernel(const uint8_t* __restrict__ xm, const uint8_t* __restrict__ ym,
                   const uint8_t* __restrict__ inf8, const uint8_t* __restrict__ km, u32* bk,
                   int steps, int lanes) {
    const TeamT tm = make_team<kTeam>();
    const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / kTeam);
    if (lane >= lanes) return;
    const int k = lane >> 6, w = lane & 63;
    for (int b = 0; b < 16; b++) bk[(size_t)(b * kWords + 24) * lanes + lane] = 1u;
    for (int s = 0; s < steps; s++) {
        const int j = k * steps + s;
        if (inf8[j]) continue;
        const u32 byte = km[(size_t)j * 32 + (w >> 1)];
        const int d = (int)((w & 1) ? (byte & 15u) : (byte >> 4));
        if (d == 0) continue;
        u32 qx[8], qy[8], X[8], Y[8], Z[8];
        bool inf;
        fe_from_be32(qx, xm + (size_t)j * 32);
        fe_from_be32(qy, ym + (size_t)j * 32);
        ld_bucket(bk, lanes, d, lane, X, Y, Z, inf);
        pt_add_mixed_complete(tm, X, Y, Z, inf, qx, qy, false);
        st_bucket(bk, lanes, d, lane, X, Y, Z, inf);
    }
}

// One merge level: items (j, b, w), j < half, b = 1 .. 15, w fastest.
__global__ void __launch_bounds__(kThreads, 1)
msm_merge_kernel(u32* bk, int half, int lanes) {
    const TeamT tm = make_team<kTeam>();
    const int item = (int)((blockIdx.x * blockDim.x + threadIdx.x) / kTeam);
    if (item >= half * 15 * 64) return;
    const int w = item & 63, jb = item >> 6;
    const int j = jb / 15, b = jb % 15 + 1;
    const int lo = j * 64 + w, hi = (j + half) * 64 + w;
    u32 X[8], Y[8], Z[8], X2[8], Y2[8], Z2[8];
    bool inf, inf2;
    ld_bucket(bk, lanes, b, lo, X, Y, Z, inf);
    ld_bucket(bk, lanes, b, hi, X2, Y2, Z2, inf2);
    pt_add_full_complete(tm, X, Y, Z, inf, X2, Y2, Z2, inf2);
    st_bucket(bk, lanes, b, lo, X, Y, Z, inf);
}

__global__ void __launch_bounds__(64 * kTeam, 1)
msm_tail_kernel(const u32* __restrict__ bk, int lanes, u32* __restrict__ out) {
    __shared__ __align__(16) u32 win[64 * kWords];
    const TeamT tm = make_team<kTeam>();
    const int w = (int)(threadIdx.x / kTeam);
    u32 RX[8], RY[8], RZ[8], SX[8], SY[8], SZ[8], EX[8], EY[8], EZ[8];
    bool rinf = true, sinf = true, einf;
    fe_set_small(RX, 1u);
    fe_set_small(RY, 1u);
    fe_set_small(RZ, 0u);
    fe_copy(SX, RX);
    fe_copy(SY, RY);
    fe_copy(SZ, RZ);
    for (int b = 15; b >= 1; b--) {
        ld_bucket(bk, lanes, b, w, EX, EY, EZ, einf);
        pt_add_full_complete(tm, RX, RY, RZ, rinf, EX, EY, EZ, einf);  // running += B_b
        pt_add_full_complete(tm, SX, SY, SZ, sinf, RX, RY, RZ, rinf);  // total += running
    }
    if (tm.t == 0) {
        u32* d = win + w * kWords;
#pragma unroll
        for (int i = 0; i < 8; i++) {
            d[i] = SX[i];
            d[8 + i] = SY[i];
            d[16 + i] = SZ[i];
        }
        d[24] = sinf ? 1u : 0u;
    }
    __syncthreads();
    if (threadIdx.x >= kTeam) return;  // team 0: the Horner pass
    bool ainf = true;
    fe_set_small(RX, 1u);
    fe_set_small(RY, 1u);
    fe_set_small(RZ, 0u);
    for (int i = 0; i < 64; i++) {
        if (!ainf) {
            for (int r = 0; r < 4; r++) pt_double(tm, RX, RY, RZ);
        }
        const u32* s = win + i * kWords;
#pragma unroll
        for (int q = 0; q < 8; q++) {
            EX[q] = s[q];
            EY[q] = s[8 + q];
            EZ[q] = s[16 + q];
        }
        pt_add_full_complete(tm, RX, RY, RZ, ainf, EX, EY, EZ, s[24] != 0u);
    }
    if (tm.t == 0) {
        if (ainf) {
            fe_set_small(RX, 1u);
            fe_set_small(RY, 1u);
            fe_set_small(RZ, 0u);
        }
        fe_canon(SX, RX);
        fe_canon(SY, RY);
        fe_canon(SZ, RZ);
#pragma unroll
        for (int i = 0; i < 8; i++) {
            out[i] = SX[i];
            out[8 + i] = SY[i];
            out[16 + i] = SZ[i];
        }
        out[24] = ainf ? 1u : 0u;
    }
}

inline unsigned blocks(long long threads) {
    return (unsigned)((threads + kThreads - 1) / kThreads);
}

bool bad_shape(int M, int K) {
    return K < 1 || K > 128 || (K & (K - 1)) != 0 || M <= 0 || M % K != 0;
}

}  // namespace

// bk: scratch of 16 x 25 x (64 K) words; every bucket's flag is set to
// infinity here before the walk.
extern "C" int msm_buckets(const uint8_t* xm, const uint8_t* ym, const uint8_t* inf8,
                           const uint8_t* km, u32* bk, int M, int K, void* stream) {
    if (bad_shape(M, K)) return (int)cudaErrorInvalidValue;
    const int lanes = K * 64;
    msm_buckets_kernel<<<blocks((long long)kTeam * lanes), kThreads, 0, (cudaStream_t)stream>>>(
        xm, ym, inf8, km, bk, M / K, lanes);
    return (int)cudaGetLastError();
}

// One merge level: streams [0, half) += streams [half, 2 half).
extern "C" int msm_merge(u32* bk, int K, int half, void* stream) {
    if (bad_shape(K, K) || half < 1 || 2 * half > K) return (int)cudaErrorInvalidValue;
    const long long items = (long long)half * 15 * 64;
    msm_merge_kernel<<<blocks(kTeam * items), kThreads, 0, (cudaStream_t)stream>>>(bk, half,
                                                                                  K * 64);
    return (int)cudaGetLastError();
}

// out: 25 words (X, Y, Z canonical, then the inf flag).
extern "C" int msm_tail(const u32* bk, int K, u32* out, void* stream) {
    if (bad_shape(K, K)) return (int)cudaErrorInvalidValue;
    msm_tail_kernel<<<1, 64 * kTeam, 0, (cudaStream_t)stream>>>(bk, K * 64, out);
    return (int)cudaGetLastError();
}

// The whole MSM: the bucket walk, log2 K merge levels, the tail.
extern "C" int msm_run(const uint8_t* xm, const uint8_t* ym, const uint8_t* inf8,
                       const uint8_t* km, u32* bk, u32* out, int M, int K, void* stream) {
    int rc = msm_buckets(xm, ym, inf8, km, bk, M, K, stream);
    for (int half = K / 2; rc == 0 && half >= 1; half /= 2) rc = msm_merge(bk, K, half, stream);
    if (rc == 0) rc = msm_tail(bk, K, out, stream);
    return rc;
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
