// The pair design of the GLV verify kernels K6 (glv_dev_verify) and K7
// (glv_verify), for sm_90a: the lane of glv_lane.cuh run by a team of L
// pairs (secp256k1_pair.cuh). glv_verify.cu's head note says what a lane
// computes, what bounds it, and how the two designs differ; chip_smoke.py
// times both in one call and ops/secp256k1.GLV_LAUNCH picks per bucket.
// Compiled on its own so that nvcc builds the two designs in parallel.

#include "glv_lane.cuh"

namespace {

// The pair design: a team of L pairs (2L threads) a lane, each multiply
// split over a pair (secp256k1_pair.cuh).
template <int L>
__global__ void __launch_bounds__(kMaxBlock, 1) glv_dev_verify_pair_kernel(GLV_DEV_PARAMS) {
    glv_dev_lane(make_pair_team<L>(), GLV_DEV_ARGS);
}

template <int L>
__global__ void __launch_bounds__(kMaxBlock, 1) glv_verify_pair_kernel(GLV_HOST_PARAMS) {
    glv_host_lane(make_pair_team<L>(), GLV_HOST_ARGS);
}

// Field-op chains (chip_smoke.py checks and times the products the two
// designs are built from): thread i loads operand pair (i / 2) mod n (a, b:
// 8 + 8 words; the two threads of a pair share one) and runs `iters`
// dependent steps r = OP(r, b) from r = a: 0 fe_mul, 1 fe_sqr, 2
// fe_mul_pair (the pair together), 3 fe_add; out gets each thread's r.
template <int OP>
__global__ void glv_field_chain_kernel(const u32* __restrict__ in, u32* __restrict__ out, int n,
                                       int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int pr = (i >> 1) % n;
    u32 r[8], b[8], t[8];
#pragma unroll
    for (int w = 0; w < 8; w++) {
        r[w] = in[(size_t)pr * 16 + w];
        b[w] = in[(size_t)pr * 16 + 8 + w];
    }
    for (int it = 0; it < iters; it++) {
        if constexpr (OP == 0) fe_mul(t, r, b);
        if constexpr (OP == 1) fe_sqr(t, r);
        if constexpr (OP == 2) fe_mul_pair(0xffffffffu, threadIdx.x & 1u, t, r, b);
        if constexpr (OP == 3) fe_add(t, r, b);
        fe_copy(r, t);
    }
#pragma unroll
    for (int w = 0; w < 8; w++) out[(size_t)i * 8 + w] = r[w];
}

}  // namespace

// Plain C entries of the pair design, with the arguments of glv_verify.cu's
// glv_dev_verify and glv_verify but `pairs` (1 or 4) in place of `team`:
// a team of `pairs` pairs (2 pairs threads) verifies one lane; `block`
// threads make a block. Each launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for another
// `pairs`, or a block size that is not a multiple of 32 up to 128).
extern "C" int glv_dev_verify_pair(const uint8_t* u1m, const uint8_t* u2m, const uint8_t* qxb,
                                   const uint8_t* qyb, const uint8_t* qinf8, const uint8_t* r0b,
                                   const uint8_t* rnb, const uint8_t* wrap8, const u32* comb,
                                   uint8_t* ok, uint8_t* degen, int B, int pairs, int block,
                                   void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define DEV(L) launch<2 * L>(glv_dev_verify_pair_kernel<L>, B, block, s, u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen)
    switch (pairs) {
        case 1: return DEV(1);
        case 4: return DEV(4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DEV
}

extern "C" int glv_verify_pair(const uint8_t* d1m, const uint8_t* d2m, const uint8_t* sg1,
                               const uint8_t* sg2, const uint8_t* s1m, const uint8_t* s2m,
                               const uint8_t* ydiff8, const uint8_t* qxb, const uint8_t* qyb,
                               const uint8_t* qinf8, const uint8_t* r0b, const uint8_t* rnb,
                               const uint8_t* wrap8, const u32* comb, uint8_t* ok,
                               uint8_t* degen, int B, int pairs, int block, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define HOST(L) launch<2 * L>(glv_verify_pair_kernel<L>, B, block, s, d1m, d2m, sg1, sg2, s1m, s2m, ydiff8, qxb, qyb, qinf8, r0b, rnb, wrap8, comb, ok, degen)
    switch (pairs) {
        case 1: return HOST(1);
        case 4: return HOST(4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef HOST
}

// `blocks` x `threads` (a multiple of 32) threads of glv_field_chain_kernel
// for op 0 .. 3; out holds blocks x threads x 8 words.
extern "C" int glv_field_chain(int op, const u32* in, u32* out, int n, int blocks, int threads,
                               int iters, void* stream) {
    if (n <= 0 || threads <= 0 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case 0: glv_field_chain_kernel<0><<<blocks, threads, 0, s>>>(in, out, n, iters); break;
        case 1: glv_field_chain_kernel<1><<<blocks, threads, 0, s>>>(in, out, n, iters); break;
        case 2: glv_field_chain_kernel<2><<<blocks, threads, 0, s>>>(in, out, n, iters); break;
        case 3: glv_field_chain_kernel<3><<<blocks, threads, 0, s>>>(in, out, n, iters); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
