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
// Both share one __device__ core (verify_lane).
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
// Limb form: 8 x 32-bit words, little-endian, every value canonical in
// [0, p) after every operation (products through 64-bit multiply-adds).
// Only ok, degen and the point at infinity are contract; the JAX kernel's
// 20 x 13-bit limbs are an internal form of the TPU.
//
// What bounds it on an H100: integer multiply-adds. A field multiply is 64
// 32x32->64 products plus 9 for the reduction, 146 32-bit IMADs; a squaring
// needs only 36 distinct products, 90 IMADs (this version computes it as a
// multiply). Squarings and multiplies: doubling 5 + 2, cheap mixed add
// 3 + 8, cheap full add 4 + 12, final check 1 + 2; a verify with every
// window nonzero is about 437,000 IMADs (table 19,436, each window 6,518).
// The card does 132 SMs x 64 IMADs a clock.
// Memory traffic is 258 bytes in and 2 bytes out per lane, nothing next to
// that. Design for it: one lane per thread, 128 threads a block, the
// 1.5 KB per-lane Q table in local memory (L1-resident), the G table in
// __constant__ memory; no shared memory, no inter-thread traffic.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

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

constexpr int kThreads = 128;

// ---- field arithmetic mod p = 2^256 - 2^32 - 977 (canonical values) -------

// r holds r + carry_in * 2^256, known to be < 2p: reduce it into [0, p).
// r >= p exactly when r + (2^32 + 977) overflows 2^256, and then the
// wrapped sum is r - p.
__device__ __forceinline__ void fe_reduce_once(u32 r[8], u32 carry_in) {
    u32 s[8];
    u64 t = (u64)r[0] + 977u;
    s[0] = (u32)t;
    t >>= 32;
    t += (u64)r[1] + 1u;
    s[1] = (u32)t;
    t >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
        t += r[i];
        s[i] = (u32)t;
        t >>= 32;
    }
    const bool take = (carry_in | (u32)t) != 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = take ? s[i] : r[i];
}

__device__ __forceinline__ void fe_copy(u32 r[8], const u32 a[8]) {
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = a[i];
}

__device__ __forceinline__ void fe_set_small(u32 r[8], u32 v) {
    r[0] = v;
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = 0u;
}

__device__ __forceinline__ bool fe_is_zero(const u32 a[8]) {
    u32 acc = 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) acc |= a[i];
    return acc == 0u;
}

__device__ __forceinline__ bool fe_eq(const u32 a[8], const u32 b[8]) {
    u32 acc = 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) acc |= a[i] ^ b[i];
    return acc == 0u;
}

__device__ __forceinline__ void fe_add(u32 r[8], const u32 a[8], const u32 b[8]) {
    u64 t = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        t += (u64)a[i] + b[i];
        r[i] = (u32)t;
        t >>= 32;
    }
    fe_reduce_once(r, (u32)t);
}

__device__ __forceinline__ void fe_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
    u32 borrow = 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const u64 t = (u64)a[i] - (u64)b[i] - (u64)borrow;
        r[i] = (u32)t;
        borrow = (u32)(t >> 32) & 1u;
    }
    // a < b: the wrapped value is a - b + 2^256; add p = subtract 2^32 + 977
    // (the wrapped value is at least 2^256 - p + 1, so this cannot borrow)
    const u32 m = 0u - borrow;
    u64 t = (u64)r[0] - (u64)(977u & m);
    r[0] = (u32)t;
    u32 b2 = (u32)(t >> 32) & 1u;
    t = (u64)r[1] - (u64)(1u & m) - (u64)b2;
    r[1] = (u32)t;
    b2 = (u32)(t >> 32) & 1u;
#pragma unroll
    for (int i = 2; i < 8; i++) {
        t = (u64)r[i] - (u64)b2;
        r[i] = (u32)t;
        b2 = (u32)(t >> 32) & 1u;
    }
}

// 512-bit product t -> r = t mod p, canonical. 2^256 == 2^32 + 977.
__device__ __forceinline__ void fe_reduce512(u32 r[8], const u32 t[16]) {
    u64 c = (u64)t[0] + (u64)t[8] * 977u;
    r[0] = (u32)c;
    c >>= 32;
#pragma unroll
    for (int i = 1; i < 8; i++) {
        c += (u64)t[i] + (u64)t[8 + i] * 977u + (u64)t[7 + i];
        r[i] = (u32)c;
        c >>= 32;
    }
    c += t[15];  // hi word 7 shifted by 32 bits lands at word 8
    // value = r + c * 2^256 with c < 2^34: fold again
    u64 d = (u64)r[0] + c * 977u;
    r[0] = (u32)d;
    d >>= 32;
    d += (u64)r[1] + c;
    r[1] = (u32)d;
    d >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
        d += r[i];
        r[i] = (u32)d;
        d >>= 32;
    }
    fe_reduce_once(r, (u32)d);
}

__device__ __forceinline__ void fe_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
    u32 t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (u64)a[i] * b[j] + t[i + j];
            t[i + j] = (u32)c;
            c >>= 32;
        }
        t[i + 8] = (u32)c;
    }
    fe_reduce512(r, t);
}

__device__ __forceinline__ void fe_sqr(u32 r[8], const u32 a[8]) { fe_mul(r, a, a); }

// ---- points (Jacobian; infinity is a separate flag) -------------------------

struct Jac {
    u32 X[8], Y[8], Z[8];
};

// dbl-2009-l, a = 0: the JAX pt_double. Doubling a finite point never
// reaches infinity on secp256k1 (no 2-torsion).
__device__ __noinline__ void pt_double(Jac& p) {
    u32 A[8], B[8], C[8], D[8], E[8], F[8], t[8], u[8];
    fe_sqr(A, p.X);
    fe_sqr(B, p.Y);
    fe_sqr(C, B);
    fe_add(t, p.X, B);
    fe_sqr(D, t);
    fe_add(t, A, C);
    fe_sub(D, D, t);
    fe_add(D, D, D);          // D = 2((X + B)^2 - A - C)
    fe_add(E, A, A);
    fe_add(E, E, A);          // E = 3A
    fe_sqr(F, E);
    fe_add(t, D, D);
    fe_sub(u, F, t);          // X3 = F - 2D
    fe_mul(t, p.Y, p.Z);
    fe_add(p.Z, t, t);        // Z3 = 2YZ
    fe_sub(t, D, u);
    fe_mul(t, E, t);          // E (D - X3)
    fe_add(C, C, C);
    fe_add(C, C, C);
    fe_add(C, C, C);          // 8C
    fe_sub(p.Y, t, C);        // Y3 = E (D - X3) - 8C
    fe_copy(p.X, u);
}

// Cheap mixed add p += (qx, qy), both finite, without the same/opposite
// case analysis. Returns the H == 0 flag (the caller's degen signal).
__device__ __noinline__ bool pt_add_mixed_cheap(Jac& p, const u32 qx[8], const u32 qy[8]) {
    u32 Z1Z1[8], U2[8], S2[8], H[8], R[8], HH[8], HHH[8], V[8], t[8], u[8];
    fe_sqr(Z1Z1, p.Z);
    fe_mul(U2, qx, Z1Z1);
    fe_mul(t, p.Z, Z1Z1);
    fe_mul(S2, qy, t);
    fe_sub(H, U2, p.X);
    fe_sub(R, S2, p.Y);
    const bool hz = fe_is_zero(H);
    fe_sqr(HH, H);
    fe_mul(HHH, H, HH);
    fe_mul(V, p.X, HH);
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sqr(u, R);
    fe_sub(u, u, t);          // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, u);
    fe_mul(t, R, t);
    fe_mul(V, p.Y, HHH);
    fe_sub(p.Y, t, V);        // Y3 = R (V - X3) - Y HHH
    fe_mul(p.Z, p.Z, H);      // Z3 = Z H
    fe_copy(p.X, u);
    return hz;
}

// Cheap full Jacobian add p += q, both finite; same contract as above.
__device__ __noinline__ bool pt_add_full_cheap(Jac& p, const Jac& q) {
    u32 Z1Z1[8], Z2Z2[8], U1[8], U2[8], S1[8], S2[8], H[8], R[8], HH[8], HHH[8],
        V[8], t[8], u[8];
    fe_sqr(Z1Z1, p.Z);
    fe_sqr(Z2Z2, q.Z);
    fe_mul(U1, p.X, Z2Z2);
    fe_mul(U2, q.X, Z1Z1);
    fe_mul(t, q.Z, Z2Z2);
    fe_mul(S1, p.Y, t);
    fe_mul(t, p.Z, Z1Z1);
    fe_mul(S2, q.Y, t);
    fe_sub(H, U2, U1);
    fe_sub(R, S2, S1);
    const bool hz = fe_is_zero(H);
    fe_sqr(HH, H);
    fe_mul(HHH, H, HH);
    fe_mul(V, U1, HH);
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sqr(u, R);
    fe_sub(u, u, t);          // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, u);
    fe_mul(t, R, t);
    fe_mul(V, S1, HHH);
    fe_sub(p.Y, t, V);        // Y3 = R (V - X3) - S1 HHH
    fe_mul(t, p.Z, q.Z);
    fe_mul(p.Z, t, H);        // Z3 = Z1 Z2 H
    fe_copy(p.X, u);
    return hz;
}

// ---- input decoding ---------------------------------------------------------

// 32 big-endian bytes -> 8 little-endian words, reduced mod p.
__device__ __forceinline__ void fe_from_be32(u32 r[8], const uint8_t* b) {
#pragma unroll
    for (int w = 0; w < 8; w++) {
        const uint8_t* q = b + 4 * (7 - w);
        r[w] = ((u32)q[0] << 24) | ((u32)q[1] << 16) | ((u32)q[2] << 8) | (u32)q[3];
    }
    fe_reduce_once(r, 0u);
}

// 20 limbs of 13 bits at limb-major stride B -> 8 words, reduced mod p.
// Limbs are summed (not OR-ed), so a limb wider than 13 bits still means
// its full value at weight 2^(13 i).
__device__ __forceinline__ void fe_from_limbs13(u32 r[8], const u32* plane, int lane, int B) {
    u64 acc[10];
#pragma unroll
    for (int w = 0; w < 10; w++) acc[w] = 0;
#pragma unroll
    for (int i = 0; i < 20; i++) {
        const u64 v = (u64)plane[(size_t)i * B + lane] << ((13 * i) & 31);
        acc[(13 * i) >> 5] += v & 0xFFFFFFFFull;
        acc[((13 * i) >> 5) + 1] += v >> 32;
    }
    u32 w[10];
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        c += acc[i];
        w[i] = (u32)c;
        c >>= 32;
    }
    // value = w[0..7] + (w[8] + 2^32 w[9]) 2^256: fold the high part
    const u64 hi = (u64)w[8] | ((u64)w[9] << 32);
    u64 d = (u64)w[0] + (hi & 0xFFFFFFFFull) * 977u;
    r[0] = (u32)d;
    d >>= 32;
    d += (u64)w[1] + (hi & 0xFFFFFFFFull) + (hi >> 32) * 977u;
    r[1] = (u32)d;
    d >>= 32;
    d += (u64)w[2] + (hi >> 32);
    r[2] = (u32)d;
    d >>= 32;
#pragma unroll
    for (int i = 3; i < 8; i++) {
        d += w[i];
        r[i] = (u32)d;
        d >>= 32;
    }
    fe_reduce_once(r, (u32)d);
}

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

template <class W1, class W2>
__device__ void verify_lane(const W1& win1, const W2& win2, const u32 qx[8],
                            const u32 qy[8], const u32 r0[8], const u32 rn[8],
                            bool wrap, uint8_t* ok_out, uint8_t* degen_out) {
    Jac qtab[16];  // jQ for j = 1..15; entry 0 unused
    fe_copy(qtab[1].X, qx);
    fe_copy(qtab[1].Y, qy);
    fe_set_small(qtab[1].Z, 1u);
    qtab[2] = qtab[1];
    pt_double(qtab[2]);
    for (int j = 3; j < 16; j++) {
        qtab[j] = qtab[j - 1];
        pt_add_mixed_cheap(qtab[j], qx, qy);
    }

    Jac acc;
    fe_set_small(acc.X, 1u);
    fe_set_small(acc.Y, 1u);
    fe_set_small(acc.Z, 0u);
    bool inf = true;
    bool degen = false;
#pragma unroll 1
    for (int k = 0; k < 64; k++) {
        if (!inf) {
            pt_double(acc);
            pt_double(acc);
            pt_double(acc);
            pt_double(acc);
        }
        const u32 w1 = win1(k);
        if (w1 != 0u) {
            const u32* gx = c_gtab[w1][0];
            const u32* gy = c_gtab[w1][1];
            if (inf) {
                fe_copy(acc.X, gx);
                fe_copy(acc.Y, gy);
                fe_set_small(acc.Z, 1u);
                inf = false;
            } else {
                u32 lx[8], ly[8];
                fe_copy(lx, gx);
                fe_copy(ly, gy);
                degen |= pt_add_mixed_cheap(acc, lx, ly);
            }
        }
        const u32 w2 = win2(k);
        if (w2 != 0u) {
            if (inf) {
                acc = qtab[w2];
                inf = false;
            } else {
                degen |= pt_add_full_cheap(acc, qtab[w2]);
            }
        }
    }

    u32 ZZ[8], t[8];
    fe_sqr(ZZ, acc.Z);
    fe_mul(t, r0, ZZ);
    bool ok = fe_eq(acc.X, t);
    fe_mul(t, rn, ZZ);
    ok = ok || (wrap && fe_eq(acc.X, t));
    *ok_out = (uint8_t)(ok && !inf);
    *degen_out = (uint8_t)degen;
}

__global__ void __launch_bounds__(kThreads)
w4_verify_bytes_kernel(const uint8_t* __restrict__ u1m, const uint8_t* __restrict__ u2m,
                       const uint8_t* __restrict__ qxb, const uint8_t* __restrict__ qyb,
                       const uint8_t* __restrict__ qinf8, const uint8_t* __restrict__ r0b,
                       const uint8_t* __restrict__ rnb, const uint8_t* __restrict__ wrap8,
                       uint8_t* __restrict__ ok, uint8_t* __restrict__ degen, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    if (qinf8[lane]) {
        ok[lane] = 0;
        degen[lane] = 0;
        return;
    }
    u32 qx[8], qy[8], r0[8], rn[8];
    fe_from_be32(qx, qxb + (size_t)lane * 32);
    fe_from_be32(qy, qyb + (size_t)lane * 32);
    fe_from_be32(r0, r0b + (size_t)lane * 32);
    fe_from_be32(rn, rnb + (size_t)lane * 32);
    const ByteWindows w1{u1m + (size_t)lane * 32};
    const ByteWindows w2{u2m + (size_t)lane * 32};
    verify_lane(w1, w2, qx, qy, r0, rn, wrap8[lane] != 0, ok + lane, degen + lane);
}

__global__ void __launch_bounds__(kThreads)
w4_verify_planes_kernel(const u32* __restrict__ u1w, const u32* __restrict__ u2w,
                        const u32* __restrict__ qxl, const u32* __restrict__ qyl,
                        const uint8_t* __restrict__ qinf, const u32* __restrict__ r0l,
                        const u32* __restrict__ rnl, const uint8_t* __restrict__ wrap,
                        uint8_t* __restrict__ ok, uint8_t* __restrict__ degen, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    if (qinf[lane]) {
        ok[lane] = 0;
        degen[lane] = 0;
        return;
    }
    u32 qx[8], qy[8], r0[8], rn[8];
    fe_from_limbs13(qx, qxl, lane, B);
    fe_from_limbs13(qy, qyl, lane, B);
    fe_from_limbs13(r0, r0l, lane, B);
    fe_from_limbs13(rn, rnl, lane, B);
    const PlaneWindows w1{u1w, lane, B};
    const PlaneWindows w2{u2w, lane, B};
    verify_lane(w1, w2, qx, qy, r0, rn, wrap[lane] != 0, ok + lane, degen + lane);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int w4_verify_bytes(const uint8_t* u1m, const uint8_t* u2m, const uint8_t* qxb,
                               const uint8_t* qyb, const uint8_t* qinf8, const uint8_t* r0b,
                               const uint8_t* rnb, const uint8_t* wrap8, uint8_t* ok,
                               uint8_t* degen, int B, void* stream) {
    if (B <= 0) return 0;
    const int grid = (B + kThreads - 1) / kThreads;
    w4_verify_bytes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        u1m, u2m, qxb, qyb, qinf8, r0b, rnb, wrap8, ok, degen, B);
    return (int)cudaGetLastError();
}

extern "C" int w4_verify_planes(const u32* u1w, const u32* u2w, const u32* qx, const u32* qy,
                                const uint8_t* qinf, const u32* r0, const u32* rn,
                                const uint8_t* wrap, uint8_t* ok, uint8_t* degen, int B,
                                void* stream) {
    if (B <= 0) return 0;
    const int grid = (B + kThreads - 1) / kThreads;
    w4_verify_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        u1w, u2w, qx, qy, qinf, r0, rn, wrap, ok, degen, B);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t, for every entry of the kernel library.
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
