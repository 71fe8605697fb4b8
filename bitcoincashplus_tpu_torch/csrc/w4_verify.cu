// Batch ECDSA verification on secp256k1 with 4-bit windows, for sm_90a.
//
// Replaces the two Pallas w4 kernels of the JAX package
// (bitcoincashplus_tpu/ops/secp256k1.py):
//   - _verify_kernel_w4_3d (pallas_call at secp256k1.py:912), reached
//     through ecdsa_verify_batch_pallas_w4_bytes: (B, 32) big-endian byte
//     matrices, expanded here in the kernel   -> entry w4_verify_bytes;
//   - _verify_kernel_w4 (pallas_call at secp256k1.py:827), reached through
//     ecdsa_verify_batch_pallas_w4: (64, B) window planes and (20, B)
//     13-bit limb planes expanded on the host -> entry w4_verify_planes.
// Both share one __device__ core (verify_lane). A third entry,
// w4_field_selftest, runs the field core alone on given operands.
//
// What it computes, per lane (the JAX schedule, kept so that the degen
// plane matches the JAX kernel lane for lane):
//   Q table jQ, j = 1..15, Jacobian: 2Q by doubling, then (j-1)Q + Q by the
//   cheap mixed add; G table jG, j = 1..15, affine constants (c_gtab).
//   64 MSB-first windows: 4 doublings, then the cheap mixed add of
//   G[w1] (when w1 != 0), then the cheap full add of Q[w2] (when w2 != 0).
//   A cheap add between two finite points with H == 0 (mod p) sets degen:
//   the lane's result is garbage and the host re-verifies it.
//   ok = acc finite and (X == r0 * Z^2, or wrap and X == rn * Z^2).
//   Lanes with q_inf set report ok = degen = 0 and do no work.
//
// What bounds it on an H100: integer multiply-adds. A field multiply is 64
// 32x32->64 products plus 9 for the reduction, 146 32-bit IMADs; a squaring
// needs 36 distinct products, 90 IMADs. Squarings and multiplies: doubling
// 5 + 2, cheap mixed add 3 + 8, cheap full add 4 + 12, final check 1 + 2;
// a verify with every window nonzero is about 437,000 IMADs. The card does
// 132 SMs x 64 IMADs a clock. Memory traffic is 258 bytes in and 2 bytes
// out per lane, nothing next to that.
//
// The design, for a latency-bound integer kernel:
//   - Field core (fe_*; it, the point formulas and the team live in
//     secp256k1_core.cuh, shared with glv_verify.cu): 8 x 32-bit
//     little-endian words; products by PTX carry chains (mad.lo.cc /
//     madc.hi.cc / addc.cc), each row of a product split into two
//     independent chains (the even and the odd words of a), a dedicated
//     squaring (36 products, cross terms
//     doubled), and the fold 2^256 == 2^32 + 977 (mod p) in the same
//     chains. Values are lazy: any word pattern in [0, 2^256) that is
//     congruent to the field value; fe_is_zero accepts 0 and p, and fe_eq
//     compares canonical values. Every bound is argued beside its code.
//   - No local memory: the point formulas are inlined with the accumulator
//     in registers (one copy of each formula in the window loop), the
//     per-lane Q table lives in dynamic shared memory (15 x 96 B a lane),
//     and the G table is copied from __constant__ into shared memory once
//     a block, so per-lane window reads are not serialised.
//   - A team of T threads per lane (T = 1, 2 or 4, consecutive in a warp):
//     the independent field products of each formula step ("level") are
//     split across the team, and the 8-word results exchanged with
//     __shfl_sync inside the team. All team threads hold the same values
//     and the same window digits, so a team never diverges. T and the
//     block size are launch arguments; ops/secp256k1.py picks both per
//     bucket from chip_smoke.py's measurements.
//
// The CPU model of the field core and of the team schedule is
// tests/test_torch_w4_design.py; each function below names its model.

#include "secp256k1_core.cuh"

namespace {

// jG, j = 1..15, affine (x, y), 8 little-endian words each; row 0 unused.
__constant__ u32 c_gtab[16][2][8] = {
    {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
    {{0x16f81798u, 0x59f2815bu, 0x2dce28d9u, 0x029bfcdbu, 0xce870b07u, 0x55a06295u, 0xf9dcbbacu, 0x79be667eu},
     {0xfb10d4b8u, 0x9c47d08fu, 0xa6855419u, 0xfd17b448u, 0x0e1108a8u, 0x5da4fbfcu, 0x26a3c465u, 0x483ada77u}},  // 1G
    {{0x5c709ee5u, 0xabac09b9u, 0x8cef3ca7u, 0x5c778e4bu, 0x95c07cd8u, 0x3045406eu, 0x41ed7d6du, 0xc6047f94u},
     {0x50cfe52au, 0x236431a9u, 0x3266d0e1u, 0xf7f63265u, 0x466ceaeeu, 0xa3c58419u, 0xa63dc339u, 0x1ae168feu}},  // 2G
    {{0xbce036f9u, 0x8601f113u, 0x836f99b0u, 0xb531c845u, 0xf89d5229u, 0x49344f85u, 0x9258c310u, 0xf9308a01u},
     {0x84b8e672u, 0x6cb9fd75u, 0x34c2231bu, 0x6500a999u, 0x2a37f356u, 0x0fe337e6u, 0x632de814u, 0x388f7b0fu}},  // 3G
    {{0xe8c4cd13u, 0x74fa94abu, 0x0ee07584u, 0xcc6c1390u, 0x930b1404u, 0x581e4904u, 0xc10d80f3u, 0xe493dbf1u},
     {0x47739922u, 0xcfe97bdcu, 0xbfbdfe40u, 0xd967ae33u, 0x8ea51448u, 0x5642e209u, 0xa0d455b7u, 0x51ed993eu}},  // 4G
    {{0xb240efe4u, 0xcba8d569u, 0xdc619ab7u, 0xe88b84bdu, 0x0a5c5128u, 0x55b4a725u, 0x1a072093u, 0x2f8bde4du},
     {0xa6ac62d6u, 0xdca87d3au, 0xab0d6840u, 0xf788271bu, 0xa6c9c426u, 0xd4dba9ddu, 0x36e5e3d6u, 0xd8ac2226u}},  // 5G
    {{0x60297556u, 0x2f057a14u, 0x8568a18bu, 0x82f6472fu, 0x355235d3u, 0x20453a14u, 0x755eeea4u, 0xfff97bd5u},
     {0xb075f297u, 0x3c870c36u, 0x518fe4a0u, 0xde80f0f6u, 0x7f45c560u, 0xf3be9601u, 0xacfbb620u, 0xae12777au}},  // 6G
    {{0xcac4f9bcu, 0xe92bddedu, 0x0330e39cu, 0x3d419b7eu, 0xf2ea7a0eu, 0xa398f365u, 0x6e5db4eau, 0x5cbdf064u},
     {0x087264dau, 0xa5082628u, 0x13fde7b5u, 0xa813d0b8u, 0x861a54dbu, 0xa3178d6du, 0xba255960u, 0x6aebca40u}},  // 7G
    {{0xe10a2a01u, 0x67784ef3u, 0xe5af888au, 0x0a1bdd05u, 0xb70f3c2fu, 0xaff3843fu, 0x5cca351du, 0x2f01e5e1u},
     {0x6cbde904u, 0xb5da2cb7u, 0xba5b7617u, 0xc2e213d6u, 0x132d13b4u, 0x293d082au, 0x41539949u, 0x5c4da8a7u}},  // 8G
    {{0xfc27ccbeu, 0xc35f110du, 0x4c57e714u, 0xe0979697u, 0x9f559abdu, 0x09ad178au, 0xf0c7f653u, 0xacd484e2u},
     {0xc64f9c37u, 0x05cc262au, 0x375f8e0fu, 0xadd888a4u, 0x763b61e9u, 0x64380971u, 0xb0a7d9fdu, 0xcc338921u}},  // 9G
    {{0x47e247c7u, 0x52a68e2au, 0x1943c2b7u, 0x3442d49bu, 0x1ae6ae5du, 0x35477c7bu, 0x47f3c862u, 0xa0434d9eu},
     {0x037368d7u, 0x3cbee53bu, 0xd877a159u, 0x6f794c2eu, 0x93a24c69u, 0xa3b6c7e6u, 0x5419bc27u, 0x893aba42u}},  // 10G
    {{0x5da008cbu, 0xbbec1789u, 0xe5c17891u, 0x5649980bu, 0x70c65aacu, 0x5ef4246bu, 0x58a9411eu, 0x774ae7f8u},
     {0xc953c61bu, 0x301d74c9u, 0xdff9d6a8u, 0x372db1e2u, 0xd7b7b365u, 0x0243dd56u, 0xeb6b5e19u, 0xd984a032u}},  // 11G
    {{0x70afe85au, 0xc5b0f470u, 0x9620095bu, 0x687cf441u, 0x4d734633u, 0x15c38f00u, 0x48e7561bu, 0xd01115d5u},
     {0xf4062327u, 0x6b051b13u, 0xd9a86d52u, 0x79238c5du, 0xe17bd815u, 0xa8b64537u, 0xc815e0d7u, 0xa9f34ffdu}},  // 12G
    {{0x19405aa8u, 0xdeeddf8fu, 0x610e58cdu, 0xb075fbc6u, 0xc3748651u, 0xc7d1d205u, 0xd975288bu, 0xf28773c2u},
     {0xdb03ed81u, 0x29b5cb52u, 0x521fa91fu, 0x3a1a06dau, 0x65cdaf47u, 0x758212ebu, 0x8d880a89u, 0x0ab0902eu}},  // 13G
    {{0x60e823e4u, 0xe49b241au, 0x678949e6u, 0x26aa7b63u, 0x07d38e32u, 0xfd64e67fu, 0x895e719cu, 0x499fdf9eu},
     {0x03a13f5bu, 0xc65f40d4u, 0x7a3f95bcu, 0x464279c2u, 0xa7b3d464u, 0x90f044e4u, 0xb54e8551u, 0xcac2f6c4u}},  // 14G
    {{0xe27e080eu, 0x44adbcf8u, 0x3c85f79eu, 0x31e5946fu, 0x095ff411u, 0x5a465ae3u, 0x7d43ea96u, 0xd7924d4fu},
     {0xf6a26b58u, 0xc504dc9fu, 0xd896d3a5u, 0xea40af2bu, 0x28cc6defu, 0x83842ec2u, 0xa86c72a6u, 0x581e2872u}},  // 15G
};

constexpr int kQWords = 15 * 24;   // a lane's Q table: jQ, j = 1..15, (X, Y, Z)
constexpr int kGWords = 16 * 16;   // the G table in shared memory (row 0 unused)
constexpr int kMaxBlock = 128;
constexpr int kMaxShared = 232448; // the most dynamic shared memory a block may use

// ---- input decoding ---------------------------------------------------------

struct ByteWindows {
    const uint8_t* row;  // 32 big-endian scalar bytes of this lane
    __device__ __forceinline__ u32 operator()(int k) const {
        const u32 b = row[k >> 1];
        return (k & 1) ? (b & 15u) : (b >> 4);
    }
};

struct PlaneWindows {
    const u32* plane;  // (64, B) limb-major
    int lane, B;
    __device__ __forceinline__ u32 operator()(int k) const {
        return plane[(size_t)k * B + lane] & 15u;
    }
};

// ---- the shared verify core -------------------------------------------------

// One lane, run by its team. qtab: the lane's 15 x 24 words of shared
// memory; gtab: the block's shared copy of c_gtab. final_r(r0, rn, wrap)
// decodes the r candidates and the wrap flag only for the final check,
// so that they take no registers in the window loop. Model: verify_lane.
template <int T, class W1, class W2, class R>
__device__ __forceinline__ void verify_lane(const Team<T>& tm, const W1& win1, const W2& win2,
                                            const u32 qx[8], const u32 qy[8], const R& final_r,
                                            u32* qtab, const u32* gtab, uint8_t* ok_out,
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
    if (T > 1) __syncwarp(tm.mask);

    fe_set_small(X, 1u);
    fe_set_small(Y, 1u);
    fe_set_small(Z, 0u);
    bool inf = true;
    bool degen = false;
#pragma unroll 1
    for (int k = 0; k < 64; k++) {
        if (!inf) {
#pragma unroll 1
            for (int d = 0; d < 4; d++) pt_double(tm, X, Y, Z);
        }
        const u32 w1 = win1(k);
        if (w1 != 0u) {
            u32 gx[8], gy[8];
            ld_fe(gx, gtab + 16 * w1);
            ld_fe(gy, gtab + 16 * w1 + 8);
            if (inf) {
                fe_copy(X, gx);
                fe_copy(Y, gy);
                fe_set_small(Z, 1u);
                inf = false;
            } else {
                degen |= pt_add_mixed(tm, X, Y, Z, gx, gy);
            }
        }
        const u32 w2 = win2(k);
        if (w2 != 0u) {
            const u32* q = qtab + 24 * (w2 - 1);
            u32 QX[8], QY[8], QZ[8];
            ld_fe(QX, q);
            ld_fe(QY, q + 8);
            ld_fe(QZ, q + 16);
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

// The block's shared memory: the G table, then each lane's Q table.
// Copies c_gtab in; every thread of the block must call it.
__device__ __forceinline__ u32* block_tables() {
    extern __shared__ uint4 smem[];
    u32* g = reinterpret_cast<u32*>(smem);
    const u32* src = &c_gtab[0][0][0];
    for (int i = threadIdx.x; i < kGWords; i += blockDim.x) g[i] = src[i];
    __syncthreads();
    return g;
}

template <int T>
__global__ void __launch_bounds__(kMaxBlock, 1)
w4_verify_bytes_kernel(const uint8_t* __restrict__ u1m, const uint8_t* __restrict__ u2m,
                       const uint8_t* __restrict__ qxb, const uint8_t* __restrict__ qyb,
                       const uint8_t* __restrict__ qinf8, const uint8_t* __restrict__ r0b,
                       const uint8_t* __restrict__ rnb, const uint8_t* __restrict__ wrap8,
                       uint8_t* __restrict__ ok, uint8_t* __restrict__ degen, int B) {
    u32* gtab = block_tables();
    const int slot = threadIdx.x / T;
    const int lane = blockIdx.x * (blockDim.x / T) + slot;
    if (lane >= B) return;
    const Team<T> tm = make_team<T>();
    if (qinf8[lane]) {
        if (tm.t == 0) {
            ok[lane] = 0;
            degen[lane] = 0;
        }
        return;
    }
    u32 qx[8], qy[8];
    fe_from_be32(qx, qxb + (size_t)lane * 32);
    fe_from_be32(qy, qyb + (size_t)lane * 32);
    const ByteWindows w1{u1m + (size_t)lane * 32};
    const ByteWindows w2{u2m + (size_t)lane * 32};
    const auto final_r = [=](u32 r0[8], u32 rn[8], bool& wrap) {
        fe_from_be32(r0, r0b + (size_t)lane * 32);
        fe_from_be32(rn, rnb + (size_t)lane * 32);
        wrap = wrap8[lane] != 0;
    };
    verify_lane(tm, w1, w2, qx, qy, final_r, gtab + kGWords + kQWords * slot, gtab, ok + lane,
                degen + lane);
}

template <int T>
__global__ void __launch_bounds__(kMaxBlock, 1)
w4_verify_planes_kernel(const u32* __restrict__ u1w, const u32* __restrict__ u2w,
                        const u32* __restrict__ qxl, const u32* __restrict__ qyl,
                        const uint8_t* __restrict__ qinf, const u32* __restrict__ r0l,
                        const u32* __restrict__ rnl, const uint8_t* __restrict__ wrap,
                        uint8_t* __restrict__ ok, uint8_t* __restrict__ degen, int B) {
    u32* gtab = block_tables();
    const int slot = threadIdx.x / T;
    const int lane = blockIdx.x * (blockDim.x / T) + slot;
    if (lane >= B) return;
    const Team<T> tm = make_team<T>();
    if (qinf[lane]) {
        if (tm.t == 0) {
            ok[lane] = 0;
            degen[lane] = 0;
        }
        return;
    }
    u32 qx[8], qy[8];
    fe_from_limbs13(qx, qxl, lane, B);
    fe_from_limbs13(qy, qyl, lane, B);
    const PlaneWindows w1{u1w, lane, B};
    const PlaneWindows w2{u2w, lane, B};
    const auto final_r = [=](u32 r0[8], u32 rn[8], bool& wrap_ok) {
        fe_from_limbs13(r0, r0l, lane, B);
        fe_from_limbs13(rn, rnl, lane, B);
        wrap_ok = wrap[lane] != 0;
    };
    verify_lane(tm, w1, w2, qx, qy, final_r, gtab + kGWords + kQWords * slot, gtab, ok + lane,
                degen + lane);
}

// The field core alone: per item i, with a = a[i], b = b[i] (8 words
// each, any value below 2^256), out[i] holds 42 words: fe_mul(a, b),
// fe_sqr(a), fe_add(a, b), fe_sub(a, b), fe_canon(a), then
// fe_is_zero(a) and fe_eq(a, b) as 0 / 1.
__global__ void w4_field_selftest_kernel(const u32* __restrict__ a, const u32* __restrict__ b,
                                         u32* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u32 x[8], y[8], r[8];
#pragma unroll
    for (int w = 0; w < 8; w++) {
        x[w] = a[(size_t)i * 8 + w];
        y[w] = b[(size_t)i * 8 + w];
    }
    u32* o = out + (size_t)i * 42;
    fe_mul(r, x, y);
#pragma unroll
    for (int w = 0; w < 8; w++) o[w] = r[w];
    fe_sqr(r, x);
#pragma unroll
    for (int w = 0; w < 8; w++) o[8 + w] = r[w];
    fe_add(r, x, y);
#pragma unroll
    for (int w = 0; w < 8; w++) o[16 + w] = r[w];
    fe_sub(r, x, y);
#pragma unroll
    for (int w = 0; w < 8; w++) o[24 + w] = r[w];
    fe_canon(r, x);
#pragma unroll
    for (int w = 0; w < 8; w++) o[32 + w] = r[w];
    o[40] = fe_is_zero(x) ? 1u : 0u;
    o[41] = fe_eq(x, y) ? 1u : 0u;
}

// Checks the team size and block size and sets the dynamic shared memory
// of `kernel`; returns the bytes, or 0 when the launch shape is refused.
template <class K>
size_t prepare(K kernel, int team, int block) {
    if (block <= 0 || block > kMaxBlock || block % 32 != 0) return 0;
    const size_t bytes = sizeof(u32) * (kGWords + (size_t)kQWords * (block / team));
    if (bytes > (size_t)kMaxShared) return 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
        cudaSuccess)
        return 0;
    return bytes;
}

template <int T, class... Args>
int launch_bytes(int B, int block, cudaStream_t stream, Args... args) {
    const size_t bytes = prepare(w4_verify_bytes_kernel<T>, T, block);
    if (!bytes) return (int)cudaErrorInvalidValue;
    const int lanes = block / T;
    w4_verify_bytes_kernel<T><<<(B + lanes - 1) / lanes, block, bytes, stream>>>(args..., B);
    return (int)cudaGetLastError();
}

template <int T, class... Args>
int launch_planes(int B, int block, cudaStream_t stream, Args... args) {
    const size_t bytes = prepare(w4_verify_planes_kernel<T>, T, block);
    if (!bytes) return (int)cudaErrorInvalidValue;
    const int lanes = block / T;
    w4_verify_planes_kernel<T><<<(B + lanes - 1) / lanes, block, bytes, stream>>>(args..., B);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a team size other than 1, 2 or 4, or a block
// size that is not a multiple of 32 up to 128 or needs more shared memory
// than a block may have). `team` threads verify one lane; `block` threads
// make a block.
extern "C" int w4_verify_bytes(const uint8_t* u1m, const uint8_t* u2m, const uint8_t* qxb,
                               const uint8_t* qyb, const uint8_t* qinf8, const uint8_t* r0b,
                               const uint8_t* rnb, const uint8_t* wrap8, uint8_t* ok,
                               uint8_t* degen, int B, int team, int block, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (team) {
        case 1: return launch_bytes<1>(B, block, s, u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, ok, degen);
        case 2: return launch_bytes<2>(B, block, s, u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, ok, degen);
        case 4: return launch_bytes<4>(B, block, s, u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, ok, degen);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int w4_verify_planes(const u32* u1w, const u32* u2w, const u32* qx, const u32* qy,
                                const uint8_t* qinf, const u32* r0, const u32* rn,
                                const uint8_t* wrap, uint8_t* ok, uint8_t* degen, int B,
                                int team, int block, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (team) {
        case 1: return launch_planes<1>(B, block, s, u1w, u2w, qx, qy, qinf, r0, rn, wrap, ok, degen);
        case 2: return launch_planes<2>(B, block, s, u1w, u2w, qx, qy, qinf, r0, rn, wrap, ok, degen);
        case 4: return launch_planes<4>(B, block, s, u1w, u2w, qx, qy, qinf, r0, rn, wrap, ok, degen);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int w4_field_selftest(const u32* a, const u32* b, u32* out, int n, void* stream) {
    if (n <= 0) return 0;
    w4_field_selftest_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(a, b, out, n);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t, for every entry of the kernel library.
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
