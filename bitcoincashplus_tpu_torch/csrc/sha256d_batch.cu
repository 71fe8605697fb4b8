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
// And two measuring entries: sha256d_chain, one thread hashing a chain
// of dependent sha256d_64 steps, whose time gives a hash's latency on the
// same core the kernels run (the Merkle tree's floor is a chain of them);
// and sha256_round_path, one thread running only the path from e to e'
// that every round has, whose time a round is a floor of the function.
//
// Words are big-endian u32 (SHA-256's own view), rows row-major: a header
// is 20 words, a digest 8, a pair row 16. Every row starts at a multiple
// of 16 bytes (the wrappers check the base), so a thread reads and writes
// its row as 16-byte vectors.
//
// The compression is csrc/sha256_core.cuh's (the fewest ALU
// instructions a round, constant words folded, one copy of the
// variable-block compression; its header says why).
//
// K1, one thread a header (blocks of kThreads): block 1, block 2 with the
// padding, the second hash; the compare in the same thread. Any B.
//
// sha256d_pairs, one thread a row (blocks of kThreads): 3 compressions.
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
// __syncthreads() a level.
//
// One launch up to 2^16 leaves. A tree of up to 8 levels is one block.
// A tree of 9..16 levels is 2^(levels - L) lower blocks of L levels, L
// the larger of 8 and levels - 7 (at most 128 blocks: one an SM; 2^16
// leaves are 128 blocks of 9 levels and 256 threads, where 256 blocks of
// 8 levels put two on most SMs and halved their speed): each writes its
// subtree's root and its `mutated` word to the scratch, then takes a
// ticket (an atomic add with release and acquire order); the block that
// draws the last ticket reduces the remaining levels over the blocks'
// roots (read through L2, where the other blocks' writes are) in a
// second pass of the same loop, ORs the blocks' `mutated` words and
// writes the root and `mutated`. Block 0 writes the witness. Nothing is
// zeroed before the launch: every output word is written once, and the
// ticket counter is zeroed once, by the wrapper that allocates it (one
// for each stream, so two calls on two streams never share one), and
// reset by the last block. A deeper tree chains launches of 8 levels a
// block (each node in the scratch carries the `mutated` word of its
// subtree) until 16 levels are left.
//
// Why 8 levels a block at least, and not 12. A first design reduced up to
// 2^12 leaves in one block of 1,024 threads (a 4,096-leaf bucket in one
// launch, as the reference's one dispatch), and took 0.143 ms there on
// the H100, three times its chain floor: all 4,095 pair hashes of the
// tree ran on one SM, so the block was bound by its SM's ALU pipe, not by
// the chain of levels. With 8 levels a block the first level's 2,048
// pairs spread over 16 SMs, and the last block starts from 16 nodes.
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
// What bounds them on an H100: 32-bit integer instructions, and at the
// node's shapes (2,048 headers, a 4,096-leaf tree: a few thousand
// compressions, under a microsecond of the card's integer rate) the
// longest thread's: one warp a scheduler issues its chain of hashes (the
// tree's levels, 3 dependent compressions each) alone, at about two
// clocks an ALU instruction. chip_smoke.py counts the instructions from
// the rounds, measures the chain with sha256d_chain and a round's
// dependent path with sha256_round_path.
//
// Each entry launches on `stream` and returns the cudaError_t of its
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_core.cuh"

namespace {

using sha256::u32;
typedef uint64_t u64;

constexpr int kThreads = 128;      // K1 and sha256d_pairs
constexpr int kTreeLevels = 8;      // levels of a chained launch's block, and the least
constexpr int kTreeBlocksLog2 = 7;  // at most 2^7 blocks below the last block: one an SM
constexpr int kTreeThreads = 1 << kTreeLevels;  // 2^16 leaves: 128 blocks of 9 levels
// shared memory of a tree block: region 0 (the even levels' outputs, S
// nodes) and region 1 (the odd levels', S / 2 nodes), 8 words a node
constexpr size_t tree_smem(int S) { return (size_t)(8 * S + 8 * (S / 2)) * sizeof(u32); }

__device__ __forceinline__ u32 bswap32(u32 x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void load8(const u32* __restrict__ src, u32 v[8]) {
    const uint4 x = reinterpret_cast<const uint4*>(src)[0];
    const uint4 y = reinterpret_cast<const uint4*>(src)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// the same through L2 (ld.global.cg): nodes other blocks of this launch wrote
__device__ __forceinline__ void load8_l2(const u32* src, u32 v[8]) {
    const uint4 x = __ldcg(reinterpret_cast<const uint4*>(src));
    const uint4 y = __ldcg(reinterpret_cast<const uint4*>(src) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// A ticket: one more block has written its root and `mutated` word. The
// add releases this thread's writes and acquires the other blocks' (the
// block's other threads read them after a __syncthreads()).
__device__ __forceinline__ u32 take_ticket(u32* tickets) {
    u32 t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(t) : "l"(tickets) : "memory");
    return t;
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
    u32 w[16], tail[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint4 x = row[q];
        w[4 * q] = x.x; w[4 * q + 1] = x.y; w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
    }
    const uint4 x = row[4];
    tail[0] = x.x; tail[1] = x.y; tail[2] = x.z; tail[3] = x.w;
    u32 h[8];
    sha256::sha256d_80(w, tail, h);
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
    sha256::sha256d_64(w, h);
    store8(out + 8 * i, h);
}

// ---- K2: the Merkle tree ------------------------------------------------------

struct Subtree {
    bool mutated;     // the block's: the same in every thread
    const u32* root;  // node 0 of the top level's region, word w at root[w * stride]
    int stride;
};

// Reduces, in one block, nodes [b << lv, (b + 1) << lv) of a level held
// in global memory (src, 8 words a node, read through L2: the last
// block's nodes are other blocks' writes of this launch) through lv
// levels; m is the whole tree's live count at that level. witness, when
// not null, takes the hash of pair 0 of the tree's first level (block 0
// of the first launch passes it).
__device__ __forceinline__ Subtree reduce_subtree(const u32* src, u64 b, int lv, u64 m,
                                                  u32* __restrict__ witness, u32* sm) {
    const int S = 1 << (lv - 1);  // first-level pairs
    // level j writes region j & 1: region 0 (S nodes) at sm, region 1
    // (S / 2 nodes) after it; node k's word w at region[w * stride + k]
    u32* const r1 = sm + 8 * S;
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
                load8_l2(src + 16 * gi, w);
                if (live) load8_l2(src + 16 * gi + 8, w + 8);
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
            const bool wit = witness != nullptr && j == 0 && gi == 0;
            if (done) {
#pragma unroll
                for (int k = 0; k < 8; ++k) out[k * out_stride + i] = w[k];
            }
            if (!done || wit) {
                u32 h[8];
                sha256::sha256d_64(w, h);
                if (wit) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) witness[k] = h[k];
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
    const bool odd = (lv - 1) & 1;
    return {__syncthreads_or(mut) != 0, odd ? r1 : sm, odd ? S / 2 : S};
}

// One launch: block b reduces nodes [b << lv, (b + 1) << lv) of src (the
// leaves, or the last launch's roots with their `mutated` words src_mut)
// through lv levels; m is the whole tree's live count at src's level.
//   - top < 0: a chained launch; the block writes its root to dst[b] and
//     its `mutated` word to dst_mut[b].
//   - top == 0: the last launch, one block; it writes out.
//   - top > 0: the last launch; the block writes dst[b], dst_mut[b] and
//     takes a ticket; the block that draws the last reduces the top `top`
//     levels over dst (a second pass of the same loop, so the kernel
//     holds one copy of the hash), writes out and resets the counter.
// out: the root (8 words), mutated (1), the witness (8); the first launch
// (bottom) writes the witness.
__global__ void __launch_bounds__(kTreeThreads)
merkle_tree_kernel(const u32* src, const u32* __restrict__ src_mut, int lv, u64 m, int top,
                   int bottom, u32* dst, u32* dst_mut, u32* __restrict__ tickets,
                   u32* __restrict__ out) {
    extern __shared__ u32 sm[];
    __shared__ bool last;
    u64 b = blockIdx.x;
    u32* witness = bottom && b == 0 ? out + 9 : nullptr;
    bool below = false;  // the subtrees below this launch's inputs
    if (src_mut != nullptr) {
        for (int k = threadIdx.x; k < (1 << lv); k += blockDim.x)
            below = below || src_mut[(b << lv) + k] != 0;
    }
#pragma unroll 1
    for (;;) {
        const Subtree t = reduce_subtree(src, b, lv, m, witness, sm);
        const bool mut = __syncthreads_or(below) != 0 || t.mutated;
        if (top == 0) {
            if (threadIdx.x == 0) {
#pragma unroll
                for (int k = 0; k < 8; ++k) out[k] = t.root[k * t.stride];
                out[8] = mut;
            }
            return;
        }
        if (threadIdx.x == 0) {
#pragma unroll
            for (int k = 0; k < 8; ++k) dst[8 * b + k] = t.root[k * t.stride];
            dst_mut[b] = mut;
            if (top > 0) last = take_ticket(tickets) == gridDim.x - 1;
        }
        if (top < 0) return;
        __syncthreads();
        if (!last) return;
        // the last block: the top levels over every block's root
        for (int k = 0; k < lv; ++k) m = m <= 1 ? m : (m + 1) / 2;
        below = false;
        for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x)
            below = below || __ldcg(dst_mut + k) != 0;
        if (threadIdx.x == 0) *tickets = 0;
        src = dst;
        b = 0;
        lv = top;
        top = 0;
        witness = nullptr;
    }
}

// ---- sha256d_chain: a hash's latency ------------------------------------------

// (one thread; its words are read at threadIdx.x, so that they live in
// the per-thread registers the kernels' words do, not in the uniform
// datapath a warp-uniform value would take)
__global__ void sha256d_chain_kernel(const u32* __restrict__ seed, int steps,
                                     u32* __restrict__ out) {
    u32 x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = seed[8 * threadIdx.x + k];
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
        u32 w[16];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = w[8 + k] = x[k];
        sha256::sha256d_64(w, x);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * threadIdx.x + k] = x[k];
}

// ---- sha256_round_path: the round's dependent path alone --------------------

// (one thread: `steps` times 64 rounds of e' = K[i] + S1(e) + Ch(e, f, g),
// then g, f = f, e: the e -> e' path of a round, d + h + W[i] being known
// rounds ahead, and the rest of the round dropped. No design of one hash
// a thread computes a round faster. The seed is read at threadIdx.x, as
// in sha256d_chain.)
__global__ void sha256_round_path_kernel(const u32* __restrict__ seed, int steps,
                                         u32* __restrict__ out) {
    u32 e = seed[3 * threadIdx.x], f = seed[3 * threadIdx.x + 1], g = seed[3 * threadIdx.x + 2];
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const u32 x = sha256::K(i) + sha256::bsig1(e) + sha256::ch(e, f, g);
            g = f;
            f = e;
            e = x;
        }
    }
    out[3 * threadIdx.x] = e;
    out[3 * threadIdx.x + 1] = f;
    out[3 * threadIdx.x + 2] = g;
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
// of scratch_nodes nodes, 9 words a node (8 words each, then a mutated
// word each), at least 2^(n_levels - 8) nodes when n_levels > 8;
// tickets: one u32, zero, that this call leaves zero (needed when
// n_levels > 8; never shared with a call on another stream); out: 17
// words — the root (8), mutated (1), the witness (8). Up to 16 levels
// one launch; above, one more launch for each 8 levels.
extern "C" int merkle_tree(const u32* leaves, int n_levels, u64 m, u32* scratch,
                           long long scratch_nodes, u32* tickets, u32* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_levels < 1 || n_levels > 40) return (int)cudaErrorInvalidValue;
    if (n_levels > kTreeLevels &&
        (scratch == nullptr || tickets == nullptr ||
         scratch_nodes < (1ll << (n_levels - kTreeLevels))))
        return (int)cudaErrorInvalidValue;
    const u32* src = leaves;
    const u32* src_mut = nullptr;
    int left = n_levels, ping = 0;
    for (;;) {
        int lv = kTreeLevels, top = -1;  // a chained launch
        if (left <= kTreeLevels) {
            lv = left;  // one block
            top = 0;
        } else if (left <= 2 * kTreeLevels) {
            if (left - kTreeBlocksLog2 > lv) lv = left - kTreeBlocksLog2;
            top = left - lv;
        }
        const unsigned blocks = (unsigned)(1ull << (left - lv));
        u32* dst = scratch == nullptr ? nullptr : scratch + (long long)ping * scratch_nodes * 9;
        u32* dst_mut = dst == nullptr ? nullptr : dst + scratch_nodes * 8;
        const int S = 1 << (lv - 1);
        const int threads = S < kTreeThreads ? S : kTreeThreads;
        merkle_tree_kernel<<<blocks, threads, tree_smem(S), s>>>(
            src, src_mut, lv, m, top, src == leaves, dst, dst_mut, tickets, out);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess || top >= 0) return (int)e;
        for (int k = 0; k < lv; ++k) m = m <= 1 ? m : (m + 1) / 2;  // as each block does
        src = dst;
        src_mut = dst_mut;
        ping ^= 1;
        left -= lv;
    }
}

// One thread: x = seed; `steps` times x = sha256d(x || x); out = x.
extern "C" int sha256d_chain(const u32* seed, int steps, u32* out, void* stream) {
    sha256d_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(seed, steps, out);
    return (int)cudaGetLastError();
}

// One thread: (e, f, g) = seed; `steps` times 64 rounds of the e path;
// out = (e, f, g).
extern "C" int sha256_round_path(const u32* seed, int steps, u32* out, void* stream) {
    sha256_round_path_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(seed, steps, out);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
