// Batch ECDSA verification on secp256k1 by a joint bit ladder, for sm_90a.
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
// What it computes, per lane (the JAX program's verdict):
//   acc = infinity; for each of the 256 bits, MSB first: acc = 2 acc, then
//   acc += G where the u1 bit is set, then acc += Q where the u2 bit is
//   set; ok = acc finite and (X == r0 Z^2, or wrap_ok and X == rn Z^2).
//   Lanes with q_inf set (malformed keys, padding) report 0 and do no
//   work. The wrap gate and the poison are here, in the kernel, as in the
//   JAX program, so no host layer can misuse rn.
// The adds are the complete mixed adds of secp256k1_complete.cuh (P = inf,
// P == Q, P == -Q resolved exactly): with Q = +-G, or u1 and u2 sharing
// bits on Q = G, the accumulator meets the point being added mid-ladder,
// and only the complete add gives the group's answer there. The JAX
// program computes both adds and selects; the bits are public, so here a
// team branches on them (the team holds the same bits and never splits),
// and an infinite accumulator skips its doubling. Only the verdict is the
// contract: it is the group law's, exactly, so it equals the JAX
// program's and the plain version's (ops/secp256k1.ladder_verify_plain)
// lane for lane.
//
// What bounds it on an H100. The work is integer multiply-adds: a doubling
// is 5 squares and 2 products (742 IMADs), a generic complete mixed add 3
// squares and 8 products (1,438), so a lane with about 128 set bits in
// each scalar costs about 560,000 IMADs; 8192 lanes are 4.6 G IMADs, 0.27
// ms at 132 SMs x 64 IMADs a clock. Memory traffic is 2,370 bytes in and
// one out a lane (the 32-bit bit planes: 2,048 of them), 19 MB at 8192
// lanes, 6 us of HBM. But the launch is bound by latency: each lane is a
// chain of 256 steps, each a doubling (3 levels of independent products)
// and up to two adds (6 levels each), about 3,800 dependent levels. The
// design: a team of 4 threads a lane (Team<4> of secp256k1_core.cuh, as
// msm.cu) spreads each level's products over its threads; the scalars
// and Q are read once into shared memory (a bit is read there each step:
// no register array is indexed at run time, and the registers stay for
// the adds' temporaries); one copy of the complete add serves both the G
// and the Q add. Making it fast (a shared-memory G
// table, windows, wider teams) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_complete.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTeam = 4;  // threads a lane
constexpr int kLanes = kThreads / kTeam;
using TeamT = Team<kTeam>;

// A lane's inputs that the ladder reads every step, kept in shared memory
// (registers are the scarce resource: the complete add's temporaries take
// most of a thread's 255).
struct LaneIn {
    u32 k1[8], k2[8];  // u1, u2, little-endian words
    u32 qx[8], qy[8];  // Q, reduced mod p
};

// G, affine, 8 little-endian words each
__constant__ u32 c_gx[8] = {0x16f81798u, 0x59f2815bu, 0x2dce28d9u, 0x029bfcdbu,
                            0xce870b07u, 0x55a06295u, 0xf9dcbbacu, 0x79be667eu};
__constant__ u32 c_gy[8] = {0xfb10d4b8u, 0x9c47d08fu, 0xa6855419u, 0xfd17b448u,
                            0x0e1108a8u, 0x5da4fbfcu, 0x26a3c465u, 0x483ada77u};

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

__global__ void __launch_bounds__(kThreads, 1)
ladder_verify_kernel(const u32* __restrict__ u1b, const u32* __restrict__ u2b,
                     const u32* __restrict__ qxl, const u32* __restrict__ qyl,
                     const uint8_t* __restrict__ qinf, const u32* __restrict__ r0l,
                     const u32* __restrict__ rnl, const uint8_t* __restrict__ wrap,
                     uint8_t* __restrict__ ok, int B) {
    __shared__ LaneIn lanes_in[kLanes];
    const TeamT tm = make_team<kTeam>();
    const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / kTeam);
    if (lane >= B) return;
    if (qinf[lane]) {
        if (tm.t == 0) ok[lane] = 0;
        return;
    }
    // every thread of the team stores the same words, then reads them
    LaneIn& in = lanes_in[threadIdx.x / kTeam];
    {
        u32 t[8];
        scalar_from_bits(t, u1b, lane, B);
        fe_copy(in.k1, t);
        scalar_from_bits(t, u2b, lane, B);
        fe_copy(in.k2, t);
        fe_from_limbs13(t, qxl, lane, B);
        fe_copy(in.qx, t);
        fe_from_limbs13(t, qyl, lane, B);
        fe_copy(in.qy, t);
    }
    __syncwarp(tm.mask);
    u32 X[8], Y[8], Z[8];
    bool inf = true;
    fe_set_small(X, 1u);
    fe_set_small(Y, 1u);
    fe_set_small(Z, 0u);
    for (int i = 255; i >= 0; i--) {
        if (!inf) pt_double(tm, X, Y, Z);
        const int w = i >> 5, b = i & 31;
        const u32 bits = ((in.k1[w] >> b) & 1u) | (((in.k2[w] >> b) & 1u) << 1);
#pragma unroll 1
        for (int j = 0; j < 2; j++) {
            if (!((bits >> j) & 1u)) continue;
            u32 ax[8], ay[8];
#pragma unroll
            for (int q = 0; q < 8; q++) {
                ax[q] = j ? in.qx[q] : c_gx[q];
                ay[q] = j ? in.qy[q] : c_gy[q];
            }
            pt_add_mixed_complete(tm, X, Y, Z, inf, ax, ay, false);
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

}  // namespace

// Plain C entry (bound with ctypes): launches on `stream`, does not
// synchronise, returns cudaGetLastError(). u1b, u2b: (256, B) words;
// qx, qy, r0, rn: (20, B) words; qinf, wrap, ok: (B,) bytes.
extern "C" int ladder_verify(const u32* u1b, const u32* u2b, const u32* qx, const u32* qy,
                             const uint8_t* qinf, const u32* r0, const u32* rn,
                             const uint8_t* wrap, uint8_t* ok, int B, void* stream) {
    if (B <= 0) return 0;
    const long long threads = (long long)kTeam * B;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    ladder_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u1b, u2b, qx, qy, qinf,
                                                                         r0, rn, wrap, ok, B);
    return (int)cudaGetLastError();
}

// The message of a cudaError_t (every kernel library has this entry).
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
