// The SHA-256 core of the batch SHA-256d kernels (csrc/sha256d_batch.cu):
// one thread computes one compression at a time, every value in
// registers. csrc/sha256d_sweep.cu keeps its own copy of the rounds,
// specialised to the sweep's hoisted template.
//
// What bounds it on an H100. At the node's shapes (2,048 headers, a
// 4,096-leaf tree) a scheduler holds one warp, and a hash takes as long
// as that warp needs to issue it, in order. The integer ALU pipe (funnel
// shifts, LOP3, IADD3) takes one warp instruction every second clock (16
// lanes a scheduler), and nearly every instruction of SHA-256 is on it:
// a hash costs about two clocks an ALU instruction. So the design counts
// instructions:
//
// - The round: t1 = h + (K[i] + W[i]) + S1(e) + Ch(e, f, g) (two IADD3),
//   e' = d + t1, a' = t1 + S0(a) + Maj(a, b, c): four adds, the fewest;
//   each S three funnel shifts (SHF.R.W) and a three-input XOR (LOP3),
//   Ch and Maj one LOP3 each (any function of three inputs is one LOP3,
//   so Maj needs no b ^ c carried from round to round). h and d are known
//   rounds ahead (e and a three rounds back), so ptxas starts t1's first
//   add early, and e -> e' is SHF, LOP3, IADD3, IADD3.
// - Constant words fold. K and the IV are literals read at constant
//   indices (every loop over rounds is unrolled), and a block whose
//   constant words the caller writes as literals gets its own inlined
//   copy: K[i] + W[i] of a constant word is one immediate, and a schedule
//   word whose inputs are all constant folds away (the 64-byte message's
//   padding block: its whole schedule; a header's tail block: words
//   4..15).
// - One copy of the variable-block compression. A sha256d_64 unrolled is
//   about 3,600 instructions, 58 KB of code; with every SM streaming it,
//   SMs ran the same hash at different speeds (instruction fetch), and
//   the tree waits for its slowest block. The first block and the second
//   hash run one copy of it (a loop of two passes), the constant padding
//   block its own.
//
// Alternatives measured on the card and not kept: a five-add round with
// the shortest e -> e' path (d + h + K[i] + W[i] off the path, e' in one
// IADD3), adds moved to the multiply-add pipe, and a copy of the
// compression for each pass (PERF.md).

#pragma once

#include <cstdint>

namespace sha256 {

typedef uint32_t u32;

constexpr u32 kPad = 0x80000000u;

__host__ __device__ constexpr u32 K(int i) {
    constexpr u32 k[64] = {
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
    return k[i];
}

__device__ __forceinline__ u32 IV(int i) {
    constexpr u32 v[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                          0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    return v[i];
}

// one funnel shift (SHF.R.W); folds on constants
__device__ __forceinline__ u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }
__device__ __forceinline__ u32 bsig0(u32 x) { return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22); }
__device__ __forceinline__ u32 bsig1(u32 x) { return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25); }
__device__ __forceinline__ u32 ssig0(u32 x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
__device__ __forceinline__ u32 ssig1(u32 x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
__device__ __forceinline__ u32 ch(u32 e, u32 f, u32 g) { return g ^ (e & (f ^ g)); }
__device__ __forceinline__ u32 maj(u32 a, u32 b, u32 c) { return ((b ^ c) & a) ^ (b & c); }

struct State {
    u32 a, b, c, d, e, f, g, h;
};

// One round; kw = K[i] + W[i].
__device__ __forceinline__ void sha_round(State& s, u32 kw) {
    const u32 t1 = s.h + kw + bsig1(s.e) + ch(s.e, s.f, s.g);
    const u32 e = s.d + t1;
    const u32 a = t1 + bsig0(s.a) + maj(s.a, s.b, s.c);
    s.h = s.g; s.g = s.f; s.f = s.e; s.e = e;
    s.d = s.c; s.c = s.b; s.b = s.a; s.a = a;
}

// st = st + rounds(st, w). w becomes the rolling schedule (its values are
// consumed).
__device__ __forceinline__ void compress(u32 st[8], u32 w[16]) {
    State s = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (i >= 16)
            w[i & 15] = w[i & 15] + w[(i + 9) & 15] + ssig0(w[(i + 1) & 15]) +
                        ssig1(w[(i + 14) & 15]);
        sha_round(s, K(i) + w[i & 15]);
    }
    st[0] += s.a; st[1] += s.b; st[2] += s.c; st[3] += s.d;
    st[4] += s.e; st[5] += s.f; st[6] += s.g; st[7] += s.h;
}

__device__ __forceinline__ void set_iv(u32 st[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = IV(i);
}

// The block of a double-SHA's second hash: w = st || 0x80 || length 256
// bits; st = the IV.
__device__ __forceinline__ void second_block(u32 st[8], u32 w[16]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = st[i];
    w[8] = kPad;
#pragma unroll
    for (int i = 9; i < 15; ++i) w[i] = 0;
    w[15] = 256;
    set_iv(st);
}

// sha256d of a message whose first 16 words are w (consumed) and whose
// last block is rest(st) (the padding or a header's tail): the first
// block and the second hash are passes of one loop over one copy of the
// variable-block compression.
template <class Rest>
__device__ __forceinline__ void sha256d(u32 w[16], Rest rest, u32 out[8]) {
    u32 st[8];
    set_iv(st);
#pragma unroll 1
    for (int pass = 0;; ++pass) {
        compress(st, w);
        if (pass == 1) break;
        rest(st);
        second_block(st, w);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = st[i];
}

// sha256d of a 64-byte message (16 words, consumed): 3 compressions, the
// second over the constant padding block.
__device__ __forceinline__ void sha256d_64(u32 w[16], u32 out[8]) {
    sha256d(w, [](u32 st[8]) {
        u32 p[16];
        p[0] = kPad;
#pragma unroll
        for (int i = 1; i < 15; ++i) p[i] = 0;
        p[15] = 512;
        compress(st, p);
    }, out);
}

// sha256d of an 80-byte header: w the first 16 words (consumed), tail
// the last 4.
__device__ __forceinline__ void sha256d_80(u32 w[16], const u32 tail[4], u32 out[8]) {
    sha256d(w, [tail](u32 st[8]) {
        u32 p[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = tail[i];
        p[4] = kPad;
#pragma unroll
        for (int i = 5; i < 15; ++i) p[i] = 0;
        p[15] = 640;
        compress(st, p);
    }, out);
}

}  // namespace sha256
