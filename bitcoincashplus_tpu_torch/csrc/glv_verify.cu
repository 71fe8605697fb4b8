// Batch ECDSA verification on secp256k1 by the GLV endomorphism split, for
// sm_90a.
//
// Replaces the plain-XLA GLV programs of the JAX package
// (bitcoincashplus_tpu/ops/secp256k1.py):
//   - _glv_dev_program (secp256k1.py:1559): the w4 byte matrices in, the
//     lattice split of u1 and u2 on the device, then the verify
//                                             -> entry glv_dev_verify (K6);
//   - _glv_program (:1296): the host split's byte matrices in (the
//     arrays of ops/ecdsa_batch._glv_pack_parts) -> entry glv_verify (K7);
//   - _glv_decompose_program (:1539): the split alone
//                                             -> entry glv_decompose.
//
// What it computes, per lane (the JAX schedule, kept so that the degen
// plane matches the JAX programs lane for lane):
//   The split k = k1 + lambda k2 (mod n), |k1|, |k2| < 2^128, of u1 and u2:
//   c~ = floor(k g / 2^384) for the Barrett constants g1, g2, bumped by one
//   where e = m k - c~ n has e >= 0 and 2e >= n; exact 32-bit word
//   arithmetic, equal to the Python glv_decompose(k mod n) for every
//   k < 2^256. u1's halves are the comb digits (16 little-endian bytes,
//   the G and lambda G streams), u2's the ladder windows (32 MSB-first
//   nibbles, the Q and lambda Q streams); the first Q-stream sign is
//   folded into qy (qy -> p - qy), the second is ydiff = n1 ^ n2 of u2.
//   T1[j] = j Q', j = 1..15: 2Q' by doubling, then (j-1)Q' + Q' by the
//   cheap mixed add (their H == 0 flags ignored, as the reference does);
//   T2[j] = (beta X, -+Y, Z) of T1[j], formed at the gather (Y negated
//   where ydiff). 32 windows: 4 doublings, then the cheap full add of
//   T1[w1], then of T2[w2]. 16 comb teeth i: the cheap mixed add of the
//   comb entry (x, y)[i][sg1 256 + d1], then of (beta x, y)[i][sg2 256 +
//   d2]. A cheap add between two finite points with H == 0 (mod p) sets
//   degen. ok = acc finite and (X == r0 Z^2, or wrap and X == rn Z^2).
//   Lanes with q_inf set report ok = degen = 0 and do no work.
//
// What bounds it on an H100: integer multiply-adds, as the w4 kernel
// (w4_verify.cu): a field multiply is 146 32-bit IMADs, a squaring 90. Per
// lane: T1 19,436; 32 x (4 doublings + 2 cheap full adds) 230,144; 32 comb
// cheap mixed adds 46,016; the beta X products (15 in the least work; this
// kernel forms one at each nonzero lambda Q window, up to 32) 2,190; the
// final check 382; the split about 1,300 — about 299,000 against w4's
// 437,000. Memory: 258 bytes in a lane (glv_verify: 226) and 2 out, and up
// to 64 random 32-byte comb reads a lane from a 786 KB table that stays in
// L2.
//
// What holds it back at the main path's shapes: latency, not the card's
// rate. 2048 lanes at T = 4 make 256 warps for 528 warp schedulers, so a
// launch takes one lane's chain of dependent levels (7% of the IMAD
// bound), and each level waits on a whole product: two carry chains
// through eight rows of mul512, then reduce512 (chip_smoke.py times such
// chains: "field chains" in its log).
//
// Two designs share the lane (glv_lane.cuh: the schedule, the slot, the
// kernels' bodies); ops/secp256k1.GLV_LAUNCH picks one per bucket from
// chip_smoke.py's timing of both in one call:
//
// The pair design (glv_pair.cu's entries; secp256k1_pair.cuh). A team
// of L pairs (2L threads) runs a lane. A round of a level with at most L
// products spreads each multiply over a pair: thread h multiplies by b's
// words 4h .. 4h + 3 (half the rows of each carry chain), one shuffle
// swaps the halves, and both add and reduce, so both hold fe_mul's words;
// a longer round gives each thread a product whole, as below. Squares
// stay whole (fe_sqr is shorter than a split multiply). The point
// formulas' linear steps are regrouped so that fewer wait on each other
// (small multiples in one chain; X3 and the next multiplier side by
// side), with the same values mod p. Finer splits were weighed and not
// built: a word a thread (8 threads a product) gathers its operands with
// 16 shuffles and resolves carries in four more rounds of exchange, and
// splitting the rows further leaves the same reduce512 and adds an
// exchange round for less chain saved.
//
// The carry-chain design (this file's entries, a team of T = 1, 2 or 4
// threads a lane): the w4 kernel's, on the
// same header (secp256k1_core.cuh: field core of PTX carry chains on lazy
// values, point formulas in levels of independent products).
//
// Both: a lane's slot of dynamic shared memory holds T1 (15 x 96 B) and, in
// glv_dev_verify, the split (64 B); T2 is not stored (beta X at the gather
// costs about 1.6% more products and keeps 128 lanes a block within the
// SM's shared memory). The comb (16 teeth x 512 entries x (x, y, beta x),
// 32 B each: 786 KB, too large for __constant__) is read from global memory
// through the read-only path; the host builds it once a process and
// uploads it once a device (ops/secp256k1._glv_comb).

#include "glv_lane.cuh"

namespace {

// The carry-chain design: a team of T threads a lane, each product whole.
template <int T>
__global__ void __launch_bounds__(kMaxBlock, 1) glv_dev_verify_kernel(GLV_DEV_PARAMS) {
    glv_dev_lane(make_team<T>(), GLV_DEV_ARGS);
}

template <int T>
__global__ void __launch_bounds__(kMaxBlock, 1) glv_verify_kernel(GLV_HOST_PARAMS) {
    glv_host_lane(make_team<T>(), GLV_HOST_ARGS);
}

// The split alone, one lane a thread: (B, 32) big-endian scalars ->
// |k1|, |k2| as 16 little-endian bytes each, and the signs.
__global__ void glv_decompose_kernel(const uint8_t* __restrict__ km, uint8_t* __restrict__ m1o,
                                     uint8_t* __restrict__ n1o, uint8_t* __restrict__ m2o,
                                     uint8_t* __restrict__ n2o, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 k[8], m1[4], m2[4];
    bool n1, n2;
    be32_words(k, km + (size_t)lane * 32);
    glv_split(k, m1, n1, m2, n2);
#pragma unroll
    for (int i = 0; i < 16; i++) {
        m1o[(size_t)lane * 16 + i] = (uint8_t)(m1[i >> 2] >> (8 * (i & 3)));
        m2o[(size_t)lane * 16 + i] = (uint8_t)(m2[i >> 2] >> (8 * (i & 3)));
    }
    n1o[lane] = n1 ? 1 : 0;
    n2o[lane] = n2 ? 1 : 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a team size other than 1, 2 or 4, or a block
// size that is not a multiple of 32 up to 128). `team` threads verify one
// lane (the carry-chain design; glv_pair.cu's entries run the pair
// design); `block` threads make a block. `comb`: the (3, 16, 512, 8) words
// of ops/secp256k1._glv_comb on the card.
extern "C" int glv_dev_verify(const uint8_t* u1m, const uint8_t* u2m, const uint8_t* qxb,
                              const uint8_t* qyb, const uint8_t* qinf8, const uint8_t* r0b,
                              const uint8_t* rnb, const uint8_t* wrap8, const u32* comb,
                              uint8_t* ok, uint8_t* degen, int B, int team, int block,
                              void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define DEV(K, T) launch<T>(K, B, block, s, u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen)
    switch (team) {
        case 1: return DEV(glv_dev_verify_kernel<1>, 1);
        case 2: return DEV(glv_dev_verify_kernel<2>, 2);
        case 4: return DEV(glv_dev_verify_kernel<4>, 4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DEV
}

extern "C" int glv_verify(const uint8_t* d1m, const uint8_t* d2m, const uint8_t* sg1,
                          const uint8_t* sg2, const uint8_t* s1m, const uint8_t* s2m,
                          const uint8_t* ydiff8, const uint8_t* qxb, const uint8_t* qyb,
                          const uint8_t* qinf8, const uint8_t* r0b, const uint8_t* rnb,
                          const uint8_t* wrap8, const u32* comb, uint8_t* ok, uint8_t* degen,
                          int B, int team, int block, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define HOST(K, T) launch<T>(K, B, block, s, d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen)
    switch (team) {
        case 1: return HOST(glv_verify_kernel<1>, 1);
        case 2: return HOST(glv_verify_kernel<2>, 2);
        case 4: return HOST(glv_verify_kernel<4>, 4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef HOST
}

extern "C" int glv_decompose(const uint8_t* km, uint8_t* m1, uint8_t* n1, uint8_t* m2,
                             uint8_t* n2, int B, void* stream) {
    if (B <= 0) return 0;
    glv_decompose_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(km, m1, n1, m2, n2,
                                                                             B);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
