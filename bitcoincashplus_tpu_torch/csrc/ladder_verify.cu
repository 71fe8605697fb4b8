// Batch ECDSA verification on secp256k1 by a joint 4-bit window ladder
// (Straus-Shamir over u1 and u2), for sm_90a.
//
// Replaces, in the JAX package (bitcoincashplus_tpu/ops/secp256k1.py), the
// plain-XLA program ecdsa_verify_batch_jit (:508-512) over
// ecdsa_verify_batch_device (:463): the last device rung of the ECDSA
// dispatch, which the reference runs when BCP_SECP_PALLAS=0 turns the w4
// kernels off (ops/ecdsa_batch.py _dispatch_device, on pack_records'
// planes). Behind ops/secp256k1.py's ecdsa_verify_batch_jit (entry
// ladder_verify).
//
// Inputs, as pack_records lays them out for the JAX program: u1, u2 as
// (256, B) bit planes, MSB first (a plane word that is not 0 is a set
// bit); qx, qy, r0, rn as (20, B) 13-bit limb planes; q_inf and wrap_ok
// as (B,) bytes. Output: ok (B,) bytes, no degen plane.
//
// What it computes, per lane: the JAX program's verdict, ok = (u1 G +
// u2 Q finite and (X == r0 Z^2, or wrap_ok and X == rn Z^2)), with lanes
// whose q_inf is set (malformed keys, padding) reporting 0 and doing no
// work. Only the verdict is the contract, so the schedule is this
// kernel's own (the JAX program runs a bit ladder; the plain version
// ops/secp256k1.ladder_windowed_plain runs this one):
//   the Q table jQ, j = 1 .. 15 (Jacobian): Q, 2Q by a doubling, then
//   jQ = (j - 1) Q + Q by complete adds; acc = infinity; for each of
//   the 64 4-bit windows, MSB first: 4 doublings (none while acc is
//   infinity), + d1 G from G's table where u1's digit d1 is not 0, +
//   d2 Q from the Q table where u2's digit d2 is not 0. The wrap gate and
//   the poison are here, in the kernel, as in the JAX program, so no
//   host layer can misuse rn.
// The adds are the complete adds of secp256k1_complete.cuh (P = inf,
// P == Q, P == -Q resolved exactly): with Q = +-G, or u1 and u2 sharing
// digits on Q = G, the accumulator meets the point being added, and only
// the complete add gives the group's answer there. The digits are public,
// so a team branches on them (the team holds the same digits and never
// splits); a digit is 0 one time in 16, so the teams of a warp nearly
// always take the same path. The verdict is the group law's, exactly, so
// it equals the JAX program's and the bit ladder's
// (ops/secp256k1.ladder_verify_plain) lane for lane.
//
// What bounds it on an H100. The work is integer multiply-adds: a doubling
// is 5 squares and 2 products (742 IMADs), a complete full add 4 squares
// and 12 products (2,112), so a lane costs about 64 x (4 x 742 + 2 x
// 2,112) + the table's 13 adds, about 490,000 IMADs; 8192 lanes are
// 4.0 G IMADs, 0.24 ms at 132 SMs x 64 IMADs a clock. Memory traffic is
// 2,370 bytes in and one out a lane, 19 MB at 8192 lanes, 6 us of HBM.
// But the launch is bound by latency: each lane is a chain of dependent
// product levels, the table's 81 and 64 windows of 4 doublings (3 levels
// each) and two adds (6 each), about 1,620 levels (the bit ladder:
// about 3,840, both adds every step). A team of 4 threads a lane (Team<4>
// of secp256k1_core.cuh) spreads each level's products over its threads.
// G's table (15 affine multiples, Z = 1) is copied from constants into
// shared memory once a block; each lane's Q table (15 x 24 words) and
// scalars live in shared memory too (no register array is indexed at run
// time; the constant cache would serialise the different entries a
// warp's teams read). One copy of the complete full add serves the table
// and both the G and the Q add (fewer registers than a mixed add beside
// it): at a team of 4 it has the mixed add's 6 levels.

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_complete.cuh"

namespace {

constexpr int kTeam = 4;  // threads a lane
using TeamT = Team<kTeam>;
constexpr int kEntry = 24;                   // X, Y, Z of a table entry
constexpr int kTable = 15 * kEntry;          // jP, j = 1 .. 15
constexpr int kLaneWords = kTable + 16;      // the Q table, then u1 and u2
constexpr int kThreads = 128;

// jG, j = 1 .. 15, affine: (x, y), 8 little-endian words each
__constant__ u32 c_gtab[15][2][8] = {
    {{0x16f81798u, 0x59f2815bu, 0x2dce28d9u, 0x029bfcdbu,
      0xce870b07u, 0x55a06295u, 0xf9dcbbacu, 0x79be667eu},
     {0xfb10d4b8u, 0x9c47d08fu, 0xa6855419u, 0xfd17b448u,
      0x0e1108a8u, 0x5da4fbfcu, 0x26a3c465u, 0x483ada77u}},  // 1G
    {{0x5c709ee5u, 0xabac09b9u, 0x8cef3ca7u, 0x5c778e4bu,
      0x95c07cd8u, 0x3045406eu, 0x41ed7d6du, 0xc6047f94u},
     {0x50cfe52au, 0x236431a9u, 0x3266d0e1u, 0xf7f63265u,
      0x466ceaeeu, 0xa3c58419u, 0xa63dc339u, 0x1ae168feu}},  // 2G
    {{0xbce036f9u, 0x8601f113u, 0x836f99b0u, 0xb531c845u,
      0xf89d5229u, 0x49344f85u, 0x9258c310u, 0xf9308a01u},
     {0x84b8e672u, 0x6cb9fd75u, 0x34c2231bu, 0x6500a999u,
      0x2a37f356u, 0x0fe337e6u, 0x632de814u, 0x388f7b0fu}},  // 3G
    {{0xe8c4cd13u, 0x74fa94abu, 0x0ee07584u, 0xcc6c1390u,
      0x930b1404u, 0x581e4904u, 0xc10d80f3u, 0xe493dbf1u},
     {0x47739922u, 0xcfe97bdcu, 0xbfbdfe40u, 0xd967ae33u,
      0x8ea51448u, 0x5642e209u, 0xa0d455b7u, 0x51ed993eu}},  // 4G
    {{0xb240efe4u, 0xcba8d569u, 0xdc619ab7u, 0xe88b84bdu,
      0x0a5c5128u, 0x55b4a725u, 0x1a072093u, 0x2f8bde4du},
     {0xa6ac62d6u, 0xdca87d3au, 0xab0d6840u, 0xf788271bu,
      0xa6c9c426u, 0xd4dba9ddu, 0x36e5e3d6u, 0xd8ac2226u}},  // 5G
    {{0x60297556u, 0x2f057a14u, 0x8568a18bu, 0x82f6472fu,
      0x355235d3u, 0x20453a14u, 0x755eeea4u, 0xfff97bd5u},
     {0xb075f297u, 0x3c870c36u, 0x518fe4a0u, 0xde80f0f6u,
      0x7f45c560u, 0xf3be9601u, 0xacfbb620u, 0xae12777au}},  // 6G
    {{0xcac4f9bcu, 0xe92bddedu, 0x0330e39cu, 0x3d419b7eu,
      0xf2ea7a0eu, 0xa398f365u, 0x6e5db4eau, 0x5cbdf064u},
     {0x087264dau, 0xa5082628u, 0x13fde7b5u, 0xa813d0b8u,
      0x861a54dbu, 0xa3178d6du, 0xba255960u, 0x6aebca40u}},  // 7G
    {{0xe10a2a01u, 0x67784ef3u, 0xe5af888au, 0x0a1bdd05u,
      0xb70f3c2fu, 0xaff3843fu, 0x5cca351du, 0x2f01e5e1u},
     {0x6cbde904u, 0xb5da2cb7u, 0xba5b7617u, 0xc2e213d6u,
      0x132d13b4u, 0x293d082au, 0x41539949u, 0x5c4da8a7u}},  // 8G
    {{0xfc27ccbeu, 0xc35f110du, 0x4c57e714u, 0xe0979697u,
      0x9f559abdu, 0x09ad178au, 0xf0c7f653u, 0xacd484e2u},
     {0xc64f9c37u, 0x05cc262au, 0x375f8e0fu, 0xadd888a4u,
      0x763b61e9u, 0x64380971u, 0xb0a7d9fdu, 0xcc338921u}},  // 9G
    {{0x47e247c7u, 0x52a68e2au, 0x1943c2b7u, 0x3442d49bu,
      0x1ae6ae5du, 0x35477c7bu, 0x47f3c862u, 0xa0434d9eu},
     {0x037368d7u, 0x3cbee53bu, 0xd877a159u, 0x6f794c2eu,
      0x93a24c69u, 0xa3b6c7e6u, 0x5419bc27u, 0x893aba42u}},  // 10G
    {{0x5da008cbu, 0xbbec1789u, 0xe5c17891u, 0x5649980bu,
      0x70c65aacu, 0x5ef4246bu, 0x58a9411eu, 0x774ae7f8u},
     {0xc953c61bu, 0x301d74c9u, 0xdff9d6a8u, 0x372db1e2u,
      0xd7b7b365u, 0x0243dd56u, 0xeb6b5e19u, 0xd984a032u}},  // 11G
    {{0x70afe85au, 0xc5b0f470u, 0x9620095bu, 0x687cf441u,
      0x4d734633u, 0x15c38f00u, 0x48e7561bu, 0xd01115d5u},
     {0xf4062327u, 0x6b051b13u, 0xd9a86d52u, 0x79238c5du,
      0xe17bd815u, 0xa8b64537u, 0xc815e0d7u, 0xa9f34ffdu}},  // 12G
    {{0x19405aa8u, 0xdeeddf8fu, 0x610e58cdu, 0xb075fbc6u,
      0xc3748651u, 0xc7d1d205u, 0xd975288bu, 0xf28773c2u},
     {0xdb03ed81u, 0x29b5cb52u, 0x521fa91fu, 0x3a1a06dau,
      0x65cdaf47u, 0x758212ebu, 0x8d880a89u, 0x0ab0902eu}},  // 13G
    {{0x60e823e4u, 0xe49b241au, 0x678949e6u, 0x26aa7b63u,
      0x07d38e32u, 0xfd64e67fu, 0x895e719cu, 0x499fdf9eu},
     {0x03a13f5bu, 0xc65f40d4u, 0x7a3f95bcu, 0x464279c2u,
      0xa7b3d464u, 0x90f044e4u, 0xb54e8551u, 0xcac2f6c4u}},  // 14G
    {{0xe27e080eu, 0x44adbcf8u, 0x3c85f79eu, 0x31e5946fu,
      0x095ff411u, 0x5a465ae3u, 0x7d43ea96u, 0xd7924d4fu},
     {0xf6a26b58u, 0xc504dc9fu, 0xd896d3a5u, 0xea40af2bu,
      0x28cc6defu, 0x83842ec2u, 0xa86c72a6u, 0x581e2872u}},  // 15G
};

// (256, B) bit plane, MSB first, of this lane -> 8 little-endian words.
__device__ __forceinline__ void scalar_from_bits(u32 k[8], const u32* plane, int lane, int B) {
#pragma unroll
    for (int w = 0; w < 8; w++) {
        u32 v = 0u;
#pragma unroll
        for (int b = 0; b < 32; b++) {
            // plane row 255 - (32 w + 31 - b) holds bit 32 w + 31 - b
            const u32 bit = plane[(size_t)(255 - 32 * w - 31 + b) * B + lane] != 0u;
            v = (v << 1) | bit;
        }
        k[w] = v;
    }
}

// The 4-bit window i (MSB first: window 0 is bits 255 .. 252) of a
// scalar of 8 little-endian words.
__device__ __forceinline__ int window(const u32* k, int i) {
    const int j = 63 - i;  // the window's place from the least significant
    return (int)((k[j >> 3] >> (4 * (j & 7))) & 15u);
}

__device__ __forceinline__ void ld_entry(const u32* e, u32 X[8], u32 Y[8], u32 Z[8]) {
    ld_fe(X, e);
    ld_fe(Y, e + 8);
    ld_fe(Z, e + 16);
}

// Dynamic shared memory: G's table, then a slot of kLaneWords a lane.
__global__ void __launch_bounds__(kThreads, 1)
ladder_verify_kernel(const u32* __restrict__ u1b, const u32* __restrict__ u2b,
                     const u32* __restrict__ qxl, const u32* __restrict__ qyl,
                     const uint8_t* __restrict__ qinf, const u32* __restrict__ r0l,
                     const u32* __restrict__ rnl, const uint8_t* __restrict__ wrap,
                     uint8_t* __restrict__ ok, int B) {
    extern __shared__ __align__(16) u32 smem[];
    u32* gtab = smem;
    for (int i = (int)threadIdx.x; i < 15 * kEntry; i += (int)blockDim.x) {
        const int j = i / kEntry, w = i % kEntry;
        gtab[i] = w < 16 ? c_gtab[j][w >> 3][w & 7] : (w == 16 ? 1u : 0u);
    }
    __syncthreads();
    const TeamT tm = make_team<kTeam>();
    const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / kTeam);
    if (lane >= B) return;
    if (qinf[lane]) {
        if (tm.t == 0) ok[lane] = 0;
        return;
    }
    // every thread of the team stores the same words, then reads them
    u32* slot = smem + kTable + (threadIdx.x / kTeam) * kLaneWords;
    u32* qtab = slot;
    u32* k1 = slot + kTable;
    u32* k2 = k1 + 8;
    u32 X[8], Y[8], Z[8];
    bool inf = false;
    {
        u32 t[8];
        scalar_from_bits(t, u1b, lane, B);
        fe_copy(k1, t);
        scalar_from_bits(t, u2b, lane, B);
        fe_copy(k2, t);
    }
    // the Q table: Q, 2Q, then jQ = (j - 1) Q + Q (the one complete add of
    // the kernel, with Q's Z = 1)
    fe_from_limbs13(X, qxl, lane, B);
    fe_from_limbs13(Y, qyl, lane, B);
    fe_set_small(Z, 1u);
    st_point(qtab, X, Y, Z);
    __syncwarp(tm.mask);
    pt_double(tm, X, Y, Z);
    st_point(qtab + kEntry, X, Y, Z);
#pragma unroll 1
    for (int j = 2; j < 15; j++) {
        u32 AX[8], AY[8], AZ[8];
        __syncwarp(tm.mask);
        ld_entry(qtab, AX, AY, AZ);
        pt_add_full_complete(tm, X, Y, Z, inf, AX, AY, AZ, false);
        st_point(qtab + j * kEntry, X, Y, Z);
    }
    __syncwarp(tm.mask);
    inf = true;
    fe_set_small(X, 1u);
    fe_set_small(Y, 1u);
    fe_set_small(Z, 0u);
#pragma unroll 1
    for (int i = 0; i < 64; i++) {
        if (!inf) {
#pragma unroll 1
            for (int r = 0; r < 4; r++) pt_double(tm, X, Y, Z);
        }
#pragma unroll 1
        for (int h = 0; h < 2; h++) {
            const int d = window(h ? k2 : k1, i);
            if (d == 0) continue;
            u32 AX[8], AY[8], AZ[8];
            ld_entry((h ? qtab : gtab) + (d - 1) * kEntry, AX, AY, AZ);
            pt_add_full_complete(tm, X, Y, Z, inf, AX, AY, AZ, false);
        }
    }
    bool res = false;
    if (!inf) {
        u32 r0[8], rn[8], ZZ[8], t0[8], t1[8];
        fe_from_limbs13(r0, r0l, lane, B);
        fe_from_limbs13(rn, rnl, lane, B);
        level(tm, {Prod{ZZ, Z, nullptr}});
        level(tm, {Prod{t0, r0, ZZ}, Prod{t1, rn, ZZ}});
        res = fe_eq(X, t0) || (wrap[lane] != 0 && fe_eq(X, t1));
    }
    if (tm.t == 0) ok[lane] = res ? 1 : 0;
}

inline size_t shared_bytes(int threads) {
    return sizeof(u32) * (size_t)(kTable + (threads / kTeam) * kLaneWords);
}

}  // namespace

// Plain C entry (bound with ctypes): launches on `stream`, does not
// synchronise, returns cudaGetLastError(). u1b, u2b: (256, B) words;
// qx, qy, r0, rn: (20, B) words; qinf, wrap, ok: (B,) bytes. Blocks of
// 128 threads (32 lanes) take 49,568 bytes of shared memory, above the
// default 48 KB; the opt-in is per device, so it is set every launch.
extern "C" int ladder_verify(const u32* u1b, const u32* u2b, const u32* qx, const u32* qy,
                             const uint8_t* qinf, const u32* r0, const u32* rn,
                             const uint8_t* wrap, uint8_t* ok, int B, void* stream) {
    if (B <= 0) return 0;
    const size_t smem = shared_bytes(kThreads);
    const cudaError_t e = cudaFuncSetAttribute(
        ladder_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long threads = (long long)kTeam * B;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    ladder_verify_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        u1b, u2b, qx, qy, qinf, r0, rn, wrap, ok, B);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
