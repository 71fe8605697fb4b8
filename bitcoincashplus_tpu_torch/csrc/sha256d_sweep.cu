// SHA-256d proof-of-work nonce sweeps, for sm_90a.
//
// Replaces, in the JAX package (bitcoincashplus_tpu/ops/):
//   - the Pallas kernel _sweep_kernel (pallas_sweep.py:49, pallas_call at
//     :100, behind pallas_sweep_jit :88 and sweep_header_pallas :119) and
//     the XLA program sweep_fast_jit (sha256_sweep.py:330): the truncated
//     h7 candidate sweep -> kernel sweep_h7_kernel, entry sweep_h7 (a tile
//     of any size; ops/pallas_sweep.py calls it with a tile of
//     sublanes * 128 nonces and min(n_tiles, max_tiles) tiles);
//   - the XLA program sweep_jit / _sweep_tile (miner.py:69, :43): the full
//     digest and the 8-limb little-endian compare le256 (sha256.py:246)
//     -> kernel sweep_exact_kernel, entry sweep_exact.
// Both kernels share one SHA-256 round function and one chunk-2 routine.
//
// What they compute. Offsets o in [0, n_tiles * tile) from `start`, nonce
// = start + o mod 2^32 (a launch may wrap past 2^32, as the reference's
// u32 arithmetic does). The first hit is the lowest offset, taken with a
// 64-bit atomicMin on the offset (never on the nonce, which may wrap);
// tiles_done is what the reference's sequential tile loop counts:
// first_offset / tile + 1 when found, n_tiles when not. A one-thread
// finalize kernel writes (found, nonce, tiles_done); nonce is 0 when not
// found.
//
// The template (ops/sha256_sweep.py, TEMPLATE_WORDS = 64 u32 words: the
// midstate, the state after chunk-2 rounds 0..2, round 3's folded legs,
// K + w folds of rounds 4..32 and the scalar legs of schedule words
// 16..32) is hoisted once per template on the host and read by each block
// into shared memory; nothing of it is computed per nonce.
//
// What bounds it on an H100: 32-bit integer operations. It reads 256 bytes
// of template (and 32 of target) and writes 32 bytes a launch. A nonce is
// about 1,810 (h7) or 1,900 (exact) shift, funnel-shift, LOP3, PRMT and
// compare instructions, which only the integer ALU pipe executes (132 SMs
// x 64 a clock), and about 650 adds, which issue as IADD3 on that pipe or
// as IMAD on the FMA pipe beside it; so the ALU-pipe instructions set the
// least time. chip_smoke.py counts both from the rounds, checks the
// counts against this file's SASS, and reports the kernel against the
// bound.
//
// The simple design: one nonce at a time a thread, 256 threads a block,
// up to 32 nonces a thread (a block covers 256 x that many consecutive
// offsets; a launch below 2^23 nonces takes fewer a thread so that it
// still has 1024 blocks; the nonce loop is not unrolled, so its SASS body
// is one nonce's hash); rounds fully unrolled in registers. Early exit:
// before each nonce a thread reads the current minimum and stops once its
// offset is above it (offsets only grow along a thread's loop, and a
// minimum only falls, so no offset below the final minimum is ever
// skipped); a block whose first offset is above the minimum stops at its
// first check.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;
typedef unsigned long long ull;

namespace {

constexpr int kThreads = 256;
// Nonces a thread sweeps: up to 32, fewer on a small launch, so that a
// launch has at least kMinBlocks blocks (a few waves of the 132 SMs).
constexpr int kMaxPerThread = 32;
constexpr u64 kMinBlocks = 1024;

// template layout: ops/sha256_sweep.py T_* offsets
constexpr int T_MID = 0, T_ST3 = 8, T_C3T1 = 16, T_T2_3 = 17, T_KW = 18,
              T_SC = 30, T_KWSC = 47, T_WORDS = 64;

// The round constants in constant memory: read at a constant index they
// are an instruction's constant-bank operand, at any other index one load
// (a local array here would be materialized in local memory wherever the
// compiler keeps a loop rolled).
__constant__ u32 c_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
__device__ __forceinline__ u32 K(int i) { return c_K[i]; }
// The IV as literals (read at constant indices only, so they fold).
__device__ __forceinline__ u32 IV(int i) {
    constexpr u32 v[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    return v[i];
}
constexpr u32 kPad = 0x80000000u;
constexpr u32 kLen32 = 256u;  // bits of the second hash's 32-byte message

// a rotate the compiler turns into one funnel shift (SHF) and folds on
// constants
__device__ __forceinline__ u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }
__device__ __forceinline__ u32 bsig0(u32 x) { return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22); }
__device__ __forceinline__ u32 bsig1(u32 x) { return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25); }
__device__ __forceinline__ u32 ssig0(u32 x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
__device__ __forceinline__ u32 ssig1(u32 x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
__device__ __forceinline__ u32 ch(u32 e, u32 f, u32 g) { return g ^ (e & (f ^ g)); }
__device__ __forceinline__ u32 maj(u32 a, u32 b, u32 c) { return ((b ^ c) & a) ^ (b & c); }
__device__ __forceinline__ u32 bswap32(u32 x) { return __byte_perm(x, 0, 0x0123); }

struct State {
    u32 a, b, c, d, e, f, g, h;
};

// The round function both kernels share: kw = K[i] + w[i], folded.
__device__ __forceinline__ void round_kw(State& s, u32 kw) {
    const u32 t1 = s.h + kw + bsig1(s.e) + ch(s.e, s.f, s.g);
    const u32 t2 = bsig0(s.a) + maj(s.a, s.b, s.c);
    s.h = s.g; s.g = s.f; s.f = s.e; s.e = s.d + t1;
    s.d = s.c; s.c = s.b; s.b = s.a; s.a = t1 + t2;
}

// Chunk 2 of the first hash, [w0 w1 w2 nonce PAD 0*10 640], from the
// hoisted template T: the digest of the header (8 words) into d.
// Schedule words 18..32 are the template's scalar leg plus a nonce
// dependent leg v (legs 21 and 28 have no scalar part).
__device__ __forceinline__ void chunk2(const u32* T, u32 nonce, u32 d[8]) {
    const u32 n = bswap32(nonce);
    const u32* sc = T + T_SC - 16;     // sc[16..32]
    const u32* kwsc = T + T_KWSC - 16; // kwsc[16..32]
    u32 W[64];
    u32 v[33];
    W[16] = sc[16];
    W[17] = sc[17];
    v[18] = ssig0(n);
    v[19] = n;
    W[18] = sc[18] + v[18];
    W[19] = sc[19] + v[19];
#pragma unroll
    for (int i = 20; i < 25; ++i) {
        v[i] = ssig1(W[i - 2]);
        W[i] = i == 21 ? v[i] : sc[i] + v[i];
    }
#pragma unroll
    for (int i = 25; i < 33; ++i) {
        v[i] = v[i - 7] + ssig1(W[i - 2]);
        W[i] = i == 28 ? v[i] : sc[i] + v[i];
    }
#pragma unroll
    for (int i = 33; i < 64; ++i)
        W[i] = W[i - 16] + ssig0(W[i - 15]) + W[i - 7] + ssig1(W[i - 2]);

    // rounds 0..2 hoisted; round 3 consumes the nonce word
    const u32 t1 = T[T_C3T1] + n;
    State s = {t1 + T[T_T2_3], T[T_ST3], T[T_ST3 + 1], T[T_ST3 + 2],
               T[T_ST3 + 3] + t1, T[T_ST3 + 4], T[T_ST3 + 5], T[T_ST3 + 6]};
#pragma unroll
    for (int i = 4; i < 16; ++i) round_kw(s, T[T_KW + i - 4]);
    round_kw(s, kwsc[16]);
    round_kw(s, kwsc[17]);
#pragma unroll
    for (int i = 18; i < 33; ++i) round_kw(s, kwsc[i] + v[i]);
#pragma unroll
    for (int i = 33; i < 64; ++i) round_kw(s, K(i) + W[i]);
    d[0] = T[T_MID + 0] + s.a; d[1] = T[T_MID + 1] + s.b;
    d[2] = T[T_MID + 2] + s.c; d[3] = T[T_MID + 3] + s.d;
    d[4] = T[T_MID + 4] + s.e; d[5] = T[T_MID + 5] + s.f;
    d[6] = T[T_MID + 6] + s.g; d[7] = T[T_MID + 7] + s.h;
}

// The second hash's message schedule [d PAD 0*6 256] up to word `upto`;
// the constant words fold at compile time.
template <int upto>
__device__ __forceinline__ void chunk3_schedule(const u32 d[8], u32 W[64]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) W[i] = d[i];
    W[8] = kPad;
#pragma unroll
    for (int i = 9; i < 15; ++i) W[i] = 0;
    W[15] = kLen32;
#pragma unroll
    for (int i = 16; i < upto; ++i)
        W[i] = W[i - 16] + ssig0(W[i - 15]) + W[i - 7] + ssig1(W[i - 2]);
}

// h[7] of sha256d: rounds 0..56, then the e-chain of rounds 57..59 and
// round 60's t1; h7 = IV7 + e_61 = IV7 + a_57 + t1_60.
__device__ __forceinline__ u32 sha256d_h7(const u32* T, u32 nonce) {
    u32 d[8], W[64];
    chunk2(T, nonce, d);
    chunk3_schedule<61>(d, W);
    State s = {IV(0), IV(1), IV(2), IV(3), IV(4), IV(5), IV(6), IV(7)};
#pragma unroll
    for (int i = 0; i < 57; ++i) round_kw(s, K(i) + W[i]);
    // rounds 57..59: e-chain only; d_57, c_57, b_57 are the d inputs
    u32 e = s.e, f = s.f, g = s.g, h = s.h, t1;
    t1 = h + bsig1(e) + ch(e, f, g) + K(57) + W[57];
    h = g; g = f; f = e; e = s.d + t1;
    t1 = h + bsig1(e) + ch(e, f, g) + K(58) + W[58];
    h = g; g = f; f = e; e = s.c + t1;
    t1 = h + bsig1(e) + ch(e, f, g) + K(59) + W[59];
    h = g; g = f; f = e; e = s.b + t1;
    t1 = h + bsig1(e) + ch(e, f, g) + K(60) + W[60];  // round 60's t1
    return IV(7) + s.a + t1;
}

// sha256d(header) <= target as little-endian uint256 limbs (L[7] most
// significant): the reference's le256 from the top limb down.
__device__ __forceinline__ bool sha256d_le(const u32* T, const u32* L, u32 nonce) {
    u32 d[8], W[64];
    chunk2(T, nonce, d);
    chunk3_schedule<64>(d, W);
    State s = {IV(0), IV(1), IV(2), IV(3), IV(4), IV(5), IV(6), IV(7)};
#pragma unroll
    for (int i = 0; i < 64; ++i) round_kw(s, K(i) + W[i]);
    const u32 h[8] = {IV(0) + s.a, IV(1) + s.b, IV(2) + s.c, IV(3) + s.d,
                      IV(4) + s.e, IV(5) + s.f, IV(6) + s.g, IV(7) + s.h};
    bool le = bswap32(h[0]) <= L[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
        const u32 l = bswap32(h[j]);
        le = (l < L[j]) || (l == L[j] && le);
    }
    return le;
}

template <bool kExact>
__device__ __forceinline__ void sweep_block(const u32* __restrict__ tmpl,
                                            const u32* __restrict__ tgt, u32 t7,
                                            u32 start, u64 total, int per_thread,
                                            ull* min_off) {
    __shared__ u32 T[T_WORDS];
    __shared__ u32 L[8];
    const u64 base = (u64)blockIdx.x * kThreads * per_thread;
    volatile ull* vmin = min_off;
    for (int i = threadIdx.x; i < T_WORDS; i += kThreads) T[i] = tmpl[i];
    if (kExact && threadIdx.x < 8) L[threadIdx.x] = tgt[threadIdx.x];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < per_thread; ++j) {
        const u64 off = base + (u64)j * kThreads + threadIdx.x;
        if (off >= total || off > *vmin) break;
        const u32 nonce = start + (u32)off;
        bool hit;
        if constexpr (kExact)
            hit = sha256d_le(T, L, nonce);
        else
            hit = bswap32(sha256d_h7(T, nonce)) <= t7;
        if (hit) {
            atomicMin(min_off, (ull)off);
            break;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
sweep_h7_kernel(const u32* __restrict__ tmpl, u32 t7, u32 start, u64 total, int per_thread,
                ull* min_off) {
    sweep_block<false>(tmpl, nullptr, t7, start, total, per_thread, min_off);
}

__global__ void __launch_bounds__(kThreads)
sweep_exact_kernel(const u32* __restrict__ tmpl, const u32* __restrict__ tgt, u32 start,
                   u64 total, int per_thread, ull* min_off) {
    sweep_block<true>(tmpl, tgt, 0, start, total, per_thread, min_off);
}

// out[0]: the minimum offset (all ones: no hit); out[1..3]: the result.
__global__ void finalize_kernel(long long* out, u32 start, u64 n_tiles, u64 tile) {
    const ull m = (ull)out[0];
    const bool found = m != ~0ull;
    out[1] = found ? 1 : 0;
    out[2] = found ? (long long)(u32)(start + (u32)m) : 0;
    out[3] = found ? (long long)(m / tile + 1) : (long long)n_tiles;
}

int launch(const u32* tmpl, const u32* tgt, u32 t7, u32 start, u64 n_tiles, u64 tile,
           long long* out, cudaStream_t stream) {
    cudaError_t e = cudaMemsetAsync(out, 0xFF, sizeof(long long), stream);
    if (e != cudaSuccess) return (int)e;
    const u64 total = n_tiles * tile;
    if (total > 0) {
        const u64 want = (total + kMinBlocks * kThreads - 1) / (kMinBlocks * kThreads);
        const int per_thread = (int)(want < kMaxPerThread ? want : kMaxPerThread);
        const u64 chunk = (u64)kThreads * per_thread;
        const unsigned blocks = (unsigned)((total + chunk - 1) / chunk);
        ull* min_off = reinterpret_cast<ull*>(out);
        if (tgt != nullptr)
            sweep_exact_kernel<<<blocks, kThreads, 0, stream>>>(tmpl, tgt, start, total,
                                                                per_thread, min_off);
        else
            sweep_h7_kernel<<<blocks, kThreads, 0, stream>>>(tmpl, t7, start, total,
                                                             per_thread, min_off);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    finalize_kernel<<<1, 1, 0, stream>>>(out, start, n_tiles, tile);
    return (int)cudaGetLastError();
}

}  // namespace

// Each entry: out is a (4,) int64 device buffer; the launch is on
// `stream`; returns the cudaError_t of the launch.
extern "C" int sweep_h7(const u32* tmpl, u32 t7, u32 start, u64 n_tiles, u64 tile,
                        long long* out, void* stream) {
    return launch(tmpl, nullptr, t7, start, n_tiles, tile, out, (cudaStream_t)stream);
}

extern "C" int sweep_exact(const u32* tmpl, const u32* tgt, u32 start, u64 n_tiles,
                           u64 tile, long long* out, void* stream) {
    return launch(tmpl, tgt, 0, start, n_tiles, tile, out, (cudaStream_t)stream);
}
