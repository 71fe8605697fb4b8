// Batched SHA-256d for sm_90a: header batches and Merkle trees.
//
// Replaces, in the JAX package (bitcoincashplus_tpu/ops/):
//   - the XLA program sha256d_headers_jit (sha256.py:293): sha256d of each
//     80-byte header -> kernel sha256d_headers_kernel<false>, entry
//     sha256d_headers (behind ops/sha256.sha256d_headers and
//     consensus/pow.check_headers_pow_batch);
//   - the XLA program check_headers_pow_jit (sha256.py:300): the same
//     digest and the 8-limb little-endian compare le256 against one
//     target -> sha256d_headers_kernel<true>, entry check_headers_pow;
//   - the XLA program _tree_reduce_jit (merkle.py:46): the whole Merkle
//     tree -> kernel merkle_tree_kernel, entry merkle_tree (behind
//     ops/merkle.compute_merkle_root_tpu_ex and ops/dispatch.merkle_root);
//   - the XLA program _hash_pairs_jit (merkle.py:90): one flat level of
//     sha256d over 64-byte rows -> kernel sha256d_pairs_kernel, entry
//     sha256d_pairs (behind ops/merkle.sha256d_pairs, the certificate
//     MMR's level hash).
// And a measuring entry, sha256d_chain: one thread hashing a chain of
// dependent sha256d_64 steps, whose time gives a hash's latency (the
// Merkle tree's floor is a chain of them).
//
// Words are big-endian u32 (SHA-256's own view), rows row-major: a header
// is 20 words, a digest 8, a pair row 16. Every row starts at a multiple
// of 16 bytes (the wrappers check the base), so a thread reads and writes
// its row as 16-byte vectors.
//
// The compression. Round constants in __constant__ memory (read at
// constant indices: an instruction's constant-bank operand); the 16 words
// of a block in registers as a rolling schedule; all 64 rounds unrolled,
// so the padding blocks' constant words fold. Its own copy of the rounds:
// csrc/sha256d_sweep.cu specialises its rounds to the hoisted template.
//
// K1, one thread a header (blocks of 128): block 1, block 2 with the
// padding, the second hash; the compare in the same thread. Any B.
//
// sha256d_pairs, one thread a row (blocks of 128): 3 compressions.
//
// K2, the tree. The reference reduces the whole tree in one program:
// per level, pair i hashes nodes 2i and 2i+1; the odd tail pairs with
// itself through a select on the live count m (2i + 1 >= m), never
// through padding; `mutated` ORs "left == right" over whole live pairs
// (2i + 1 < m) before the self-pair; pair 0 of the first level is the
// witness; once m <= 1 the root rides through unhashed; m becomes
// (m + 1) / 2 a level. Here a block of up to 128 threads reduces a
// subtree of up to 2^8 nodes through 8 levels: the first level reads the
// pairs from global memory, every later level lives in shared memory
// (ping-pong regions of 128 and 64 nodes, word-major, 6 KB), with one
// __syncthreads() a level. A launch covers up to 8 levels, the lowest
// launch first, each over the previous launch's subtree roots (one node
// a block): a 4,096-leaf bucket is two launches (16 blocks, then one
// block over their 16 roots), 2^16 leaves two (256 blocks, then one).
// `mutated` is an atomicOr across blocks and launches; the lowest
// launch's block 0 writes the witness; the top launch (one block) writes
// the root.
//
// Why 8 levels a block and not 12. A first design reduced up to 2^12
// leaves in one block of 1,024 threads (a 4,096-leaf bucket in one
// launch, as the reference's one dispatch), and took 0.143 ms there on
// the H100, three times its chain floor: all 4,095 pair hashes of the
// tree ran on one SM (about 10.8 M ALU-pipe instructions at 64 a clock:
// 85 us), so the block was bound by its SM's ALU pipe, not by the chain
// of levels. With 8 levels a block the first level's 2,048 pairs spread
// over 16 SMs, and the top block starts from 16 nodes.
//
// Live counts. Every thread carries the WHOLE tree's live count m of its
// level, the same in every block, and tests its pair by its global index
// (blockIdx << levels above + local index): the self-pair, `mutated` and
// the ride-through are the reference's rules on the reference's indices,
// so a tail subtree self-pairs exactly where the whole tree does, and the
// ride-through waits for the whole tree's m <= 1, never a subtree's.
// Dead pairs (2i >= m, i > 0) are skipped: their outputs are read only by
// dead pairs above them, never by a live pair (whose right node, when not
// live, is replaced by its left) nor by the root, `mutated` or the
// witness; pair 0 always runs (with m = 0 it is the witness too).
//
// What bounds them on an H100: 32-bit integer operations (rotates as
// funnel shifts, sigma and Ch / Maj as LOP3 on the ALU pipe; adds as
// IADD3) — a compression is about 1,000 ALU-pipe instructions — and, at
// the node's shapes (2,048 headers, a 4,096-leaf tree: a few thousand
// compressions, under a microsecond of the card's ALU rate), latency: a
// launch of one wave, and for the tree the chain of its levels (3
// dependent compressions each) and a launch per 8 levels. chip_smoke.py
// counts the operations from the rounds and measures the chain with
// sha256d_chain.
//
// Each entry launches on `stream` and returns the cudaError_t of its
// launch.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

constexpr int kThreads = 128;      // K1 and sha256d_pairs
constexpr int kTreeLevels = 8;     // levels a tree block reduces at most
constexpr int kTreePairs = 1 << (kTreeLevels - 1);  // first-level pairs a block
constexpr int kTreeThreads = kTreePairs;
// shared memory of a tree block: region 0 (the even levels' outputs, S
// nodes) and region 1 (the odd levels', S / 2 nodes), 8 words a node
constexpr size_t tree_smem(int S) { return (size_t)(8 * S + 8 * (S / 2)) * sizeof(u32); }

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
// The IV as literals (read at constant indices only, so they fold).
__device__ __forceinline__ u32 IV(int i) {
    constexpr u32 v[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    return v[i];
}
constexpr u32 kPad = 0x80000000u;

__device__ __forceinline__ u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }
__device__ __forceinline__ u32 bsig0(u32 x) { return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22); }
__device__ __forceinline__ u32 bsig1(u32 x) { return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25); }
__device__ __forceinline__ u32 ssig0(u32 x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
__device__ __forceinline__ u32 ssig1(u32 x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
__device__ __forceinline__ u32 ch(u32 e, u32 f, u32 g) { return g ^ (e & (f ^ g)); }
__device__ __forceinline__ u32 maj(u32 a, u32 b, u32 c) { return ((b ^ c) & a) ^ (b & c); }
__device__ __forceinline__ u32 bswap32(u32 x) { return __byte_perm(x, 0, 0x0123); }

// One compression: st = st + rounds(st, w). w is the block's 16 words and
// becomes the rolling schedule (its values are consumed).
__device__ __forceinline__ void compress(u32 st[8], u32 w[16]) {
    u32 a = st[0], b = st[1], c = st[2], d = st[3];
    u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (i >= 16)
            w[i & 15] += ssig0(w[(i + 1) & 15]) + w[(i + 9) & 15] + ssig1(w[(i + 14) & 15]);
        const u32 t1 = h + bsig1(e) + ch(e, f, g) + c_K[i] + w[i & 15];
        const u32 t2 = bsig0(a) + maj(a, b, c);
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ void set_iv(u32 st[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = IV(i);
}

// The second hash of a double-SHA: SHA-256 of the 32-byte digest h, one
// padded block (h || 0x80 || len = 256 bits), into out.
__device__ __forceinline__ void sha256_of_state(const u32 h[8], u32 out[8]) {
    u32 w[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = h[i];
    w[8] = kPad;
#pragma unroll
    for (int i = 9; i < 15; ++i) w[i] = 0;
    w[15] = 256;
    set_iv(out);
    compress(out, w);
}

// sha256d of a 64-byte message (16 words, consumed): 3 compressions.
__device__ __forceinline__ void sha256d_64(u32 w[16], u32 out[8]) {
    u32 st[8];
    set_iv(st);
    compress(st, w);
    u32 p[16];
    p[0] = kPad;
#pragma unroll
    for (int i = 1; i < 15; ++i) p[i] = 0;
    p[15] = 512;
    compress(st, p);
    sha256_of_state(st, out);
}

__device__ __forceinline__ void load8(const u32* __restrict__ src, u32 v[8]) {
    const uint4 x = reinterpret_cast<const uint4*>(src)[0];
    const uint4 y = reinterpret_cast<const uint4*>(src)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__device__ __forceinline__ void store8(u32* __restrict__ dst, const u32 v[8]) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// ---- K1: a header a thread ----------------------------------------------------

template <bool kPow>
__global__ void __launch_bounds__(kThreads)
sha256d_headers_kernel(const u32* __restrict__ words, long long n, const u32* __restrict__ tgt,
                       u32* __restrict__ out, bool* __restrict__ ok) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const uint4* row = reinterpret_cast<const uint4*>(words + 20 * i);
    u32 w[16], st[8], tail[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint4 x = row[q];
        w[4 * q] = x.x; w[4 * q + 1] = x.y; w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
    }
    const uint4 x = row[4];
    tail[0] = x.x; tail[1] = x.y; tail[2] = x.z; tail[3] = x.w;
    set_iv(st);
    compress(st, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = tail[q];
    w[4] = kPad;
#pragma unroll
    for (int q = 5; q < 15; ++q) w[q] = 0;
    w[15] = 640;
    compress(st, w);
    u32 h[8];
    sha256_of_state(st, h);
    store8(out + 8 * i, h);
    if constexpr (kPow) {
        // hash <= target as little-endian uint256 limbs (limb 7 most
        // significant): the reference's le256 from the top limb down
        bool le = bswap32(h[0]) <= __ldg(tgt);
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            const u32 l = bswap32(h[j]), t = __ldg(tgt + j);
            le = (l < t) || (l == t && le);
        }
        ok[i] = le;
    }
}

// ---- sha256d_pairs: a 64-byte row a thread ---------------------------------

__global__ void __launch_bounds__(kThreads)
sha256d_pairs_kernel(const u32* __restrict__ rows, long long n, u32* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    u32 w[16], h[8];
    load8(rows + 16 * i, w);
    load8(rows + 16 * i + 8, w + 8);
    sha256d_64(w, h);
    store8(out + 8 * i, h);
}

// ---- K2: the Merkle tree ------------------------------------------------------

// One launch: block b reduces nodes [b << lv, (b + 1) << lv) of this
// launch's base level through lv levels into dst[b] (8 words). m0 is the
// whole tree's live count at the base level; `bottom` marks the tree's
// first level (the witness); flags[0] is `mutated`, flags[1..8] the
// witness.
__global__ void __launch_bounds__(kTreeThreads)
merkle_tree_kernel(const u32* __restrict__ src, u32* __restrict__ dst, int lv, u64 m0,
                   int bottom, u32* __restrict__ flags) {
    extern __shared__ u32 sm[];
    const int S = 1 << (lv - 1);  // this launch's first-level pairs a block
    // level j writes region j & 1: region 0 (S nodes) at sm, region 1
    // (S / 2 nodes) after it; node k's word w at region[w * stride + k]
    u32* const r1 = sm + 8 * S;
    const u64 b = blockIdx.x;
    u64 m = m0;
    bool mut = false;
    for (int j = 0; j < lv; ++j) {
        const int P = S >> j;  // pairs at this level in the block
        const bool odd = j & 1;
        const u32* in = odd ? sm : r1;  // level j - 1's outputs
        const int in_stride = odd ? S : S / 2;
        u32* out = odd ? r1 : sm;
        const int out_stride = odd ? S / 2 : S;
        const bool done = m <= 1;  // the root rides through
        for (int i = threadIdx.x; i < P; i += blockDim.x) {
            const u64 gi = (b << (lv - 1 - j)) + i;  // the pair's global index
            if (2 * gi >= m && gi != 0) continue;    // dead: nothing live reads it
            const bool live = 2 * gi + 1 < m;        // both nodes in the live prefix
            u32 w[16];
            if (j == 0) {
                load8(src + 16 * gi, w);
                if (live) load8(src + 16 * gi + 8, w + 8);
            } else {
#pragma unroll
                for (int k = 0; k < 8; ++k) w[k] = in[k * in_stride + 2 * i];
                if (live) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) w[8 + k] = in[k * in_stride + 2 * i + 1];
                }
            }
            if (live) {
                bool eq = true;
#pragma unroll
                for (int k = 0; k < 8; ++k) eq = eq && w[k] == w[8 + k];
                mut = mut || eq;
            } else {
#pragma unroll
                for (int k = 0; k < 8; ++k) w[8 + k] = w[k];  // the odd tail's self-pair
            }
            const bool witness = bottom && j == 0 && gi == 0;
            if (done) {
#pragma unroll
                for (int k = 0; k < 8; ++k) out[k * out_stride + i] = w[k];
            }
            if (!done || witness) {
                u32 h[8];
                sha256d_64(w, h);
                if (witness) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) flags[1 + k] = h[k];
                }
                if (!done) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) out[k * out_stride + i] = h[k];
                }
            }
        }
        __syncthreads();
        if (!done) m = (m + 1) / 2;
    }
    if (mut) atomicOr(flags, 1u);
    if (threadIdx.x == 0) {
        const bool odd = (lv - 1) & 1;
        const u32* top = odd ? r1 : sm;
        const int top_stride = odd ? S / 2 : S;
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[8 * b + k] = top[k * top_stride];
    }
}

// ---- sha256d_chain: a hash's latency ------------------------------------------

__global__ void sha256d_chain_kernel(const u32* __restrict__ seed, int steps,
                                     u32* __restrict__ out) {
    u32 x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = seed[k];
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
        u32 w[16];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = w[8 + k] = x[k];
        sha256d_64(w, x);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = x[k];
}

unsigned grid(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// words: (n, 20) u32 rows; out: (n, 8).
extern "C" int sha256d_headers(const u32* words, long long n, u32* out, void* stream) {
    if (n <= 0) return 0;
    sha256d_headers_kernel<false><<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
        words, n, nullptr, out, nullptr);
    return (int)cudaGetLastError();
}

// words: (n, 20); tgt: (8,) LE limbs; out: (n, 8); ok: (n,) bool.
extern "C" int check_headers_pow(const u32* words, long long n, const u32* tgt, u32* out,
                                 bool* ok, void* stream) {
    if (n <= 0) return 0;
    sha256d_headers_kernel<true><<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
        words, n, tgt, out, ok);
    return (int)cudaGetLastError();
}

// rows: (n, 16) u32 (left || right); out: (n, 8).
extern "C" int sha256d_pairs(const u32* rows, long long n, u32* out, void* stream) {
    if (n <= 0) return 0;
    sha256d_pairs_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(rows, n, out);
    return (int)cudaGetLastError();
}

// leaves: (2^n_levels, 8) u32; m: the live count; scratch: two buffers
// of scratch_nodes nodes each (at least 2^(n_levels - 8) nodes when
// n_levels > 8); out: 17 words — the root (8), mutated (1), the witness
// (8).
extern "C" int merkle_tree(const u32* leaves, int n_levels, u64 m, u32* scratch,
                           long long scratch_nodes, u32* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_levels < 1 || n_levels > 40) return (int)cudaErrorInvalidValue;
    if (n_levels > kTreeLevels &&
        (scratch == nullptr || scratch_nodes < (1ll << (n_levels - kTreeLevels))))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(out, 0, 17 * sizeof(u32), s);
    if (e != cudaSuccess) return (int)e;
    const u32* src = leaves;
    int left = n_levels, ping = 0, bottom = 1;
    while (left > 0) {
        const int lv = left < kTreeLevels ? left : kTreeLevels;
        const unsigned blocks = (unsigned)(1ull << (left - lv));
        u32* dst = left == lv ? out : scratch + (long long)ping * scratch_nodes * 8;
        const int S = 1 << (lv - 1);
        const int threads = S < kTreeThreads ? S : kTreeThreads;
        merkle_tree_kernel<<<blocks, threads, tree_smem(S), s>>>(src, dst, lv, m, bottom,
                                                                 out + 8);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        for (int k = 0; k < lv; ++k) m = m <= 1 ? m : (m + 1) / 2;  // as each block does
        src = dst;
        ping ^= 1;
        left -= lv;
        bottom = 0;
    }
    return 0;
}

// One thread: x = seed; `steps` times x = sha256d(x || x); out = x.
extern "C" int sha256d_chain(const u32* seed, int steps, u32* out, void* stream) {
    sha256d_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(seed, steps, out);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
