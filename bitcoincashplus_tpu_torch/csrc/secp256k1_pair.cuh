// The pair team of the GLV kernels' second design (glv_pair.cu; the team
// codes 16 + L of ops/secp256k1.GLV_TEAMS), for sm_90a: a multiply of a
// level spread over two threads, and the point formulas for that team.
//
// A team of L pairs (2L consecutive lanes of a warp) runs a lane. A level
// of independent products runs in rounds; a round of at most L products
// gives each a pair (pair l takes product l, as level<T, N> of
// secp256k1_core.cuh hands thread t product t), a longer one gives each
// thread a product whole. Within a pair, thread h multiplies a by b's
// words 4h .. 4h + 3 (four rows of
// mul512, each an even and an odd carry chain: half the rows, half the
// chain), the pair swaps the two 12-word halves with one shuffle, and each
// thread adds them (lo + hi 2^128 = a b, exact) and reduces with the
// carry-chain core's reduce512. A square is computed whole in both
// threads (fe_sqr is shorter than a split multiply), as is every linear
// step: the pair ends a round with the same words in both threads, the
// words fe_mul would give. The CPU model is tests/test_torch_glv_design.py;
// each function below names its model.

#pragma once

#include "secp256k1_core.cuh"

namespace {

template <int L>
struct PairTeam {
    u32 t;     // this thread's index in its team: pair t >> 1, half t & 1
    u32 mask;  // the team's threads in the warp (2L consecutive lanes)
};

template <int L>
__device__ __forceinline__ PairTeam<L> make_pair_team() {
    const Team<2 * L> tm = make_team<2 * L>();
    return PairTeam<L>{tm.t, tm.mask};
}

// q = a * b, exact (q < 2^384), for a 4-word b: rows 0 .. 3 of mul512 (the
// same even and odd chains; a row's fresh carry word as there). The last
// odd row cannot carry out: od <= a * b < 2^384. Model: PairField.mul_rows4.
__device__ __forceinline__ void mul_rows4(u32 q[12], const u32 a[8], const u32 b[4]) {
    u32 ev[12], od[12];
#pragma unroll
    for (int k = 0; k < 12; k++) {
        ev[k] = 0u;
        od[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
        ev[i] = mad_lo_cc(a[0], b[i], ev[i]);
        ev[i + 1] = madc_hi_cc(a[0], b[i], ev[i + 1]);
#pragma unroll
        for (int j = 2; j < 8; j += 2) {
            ev[i + j] = madc_lo_cc(a[j], b[i], ev[i + j]);
            ev[i + j + 1] = madc_hi_cc(a[j], b[i], ev[i + j + 1]);
        }
        ev[i + 8] = addc(0u, 0u);
        od[i + 1] = mad_lo_cc(a[1], b[i], od[i + 1]);
        od[i + 2] = madc_hi_cc(a[1], b[i], od[i + 2]);
#pragma unroll
        for (int j = 3; j < 8; j += 2) {
            od[i + j] = madc_lo_cc(a[j], b[i], od[i + j]);
            od[i + j + 1] = madc_hi_cc(a[j], b[i], od[i + j + 1]);
        }
        if (i + 9 < 12) od[i + 9] = addc(0u, 0u);
    }
    q[0] = ev[0];
    q[1] = add_cc(ev[1], od[1]);
#pragma unroll
    for (int k = 2; k < 11; k++) q[k] = addc_cc(ev[k], od[k]);
    q[11] = addc(ev[11], od[11]);  // a * b < 2^384: no carry out
}

// r = a * b over a pair (`half` 0 or 1, `mask` the team's lanes): the
// half products a b_lo and a b_hi (b = b_lo + 2^128 b_hi) swapped by one
// shuffle, t = a b_lo + 2^128 a b_hi < 2^512 (no carry out of word 15),
// then reduce512: the words of fe_mul(a, b) in both threads.
// Model: PairField.mul_pair.
__device__ __forceinline__ void fe_mul_pair(u32 mask, u32 half, u32 r[8], const u32 a[8],
                                            const u32 b[8]) {
    u32 bh[4];
#pragma unroll
    for (int j = 0; j < 4; j++) bh[j] = half ? b[4 + j] : b[j];
    u32 q[12], lo[12], hi[12];
    mul_rows4(q, a, bh);
#pragma unroll
    for (int k = 0; k < 12; k++) {
        const u32 o = __shfl_xor_sync(mask, q[k], 1);
        lo[k] = half ? o : q[k];
        hi[k] = half ? q[k] : o;
    }
    u32 t[16];
#pragma unroll
    for (int k = 0; k < 4; k++) t[k] = lo[k];
    t[4] = add_cc(lo[4], hi[0]);
#pragma unroll
    for (int k = 5; k < 12; k++) t[k] = addc_cc(lo[k], hi[k - 4]);
#pragma unroll
    for (int k = 12; k < 15; k++) t[k] = addc_cc(hi[k - 4], 0u);
    t[15] = addc(hi[11], 0u);
    reduce512(r, t);
}

// One level for a team of L pairs (2L threads): rounds of up to 2L
// products. A round of more than L products runs as level<2L, N> does
// (thread t computes product min(t, n - 1) whole); a round of at most L
// has a pair for each product: pair l computes product min(l, n - 1), a
// multiply split over the pair, a round of squares whole in both threads
// (a mixed round computes a square as a * a, as level<T, N> does). Every
// thread receives the n results by __shfl_sync (an exchange through
// shared memory, two 16-byte stores and 2n loads between __syncwarp
// fences, was slower on the H100). Outputs must not alias inputs of the
// same level. Model: run_level_pairs.
template <int L, int N, int C = 0>
__device__ __forceinline__ void level(const PairTeam<L>& tm, const Prod (&p)[N]) {
    constexpr int T = 2 * L;
    constexpr int n = N - C < T ? N - C : T;
    constexpr bool split = n <= L;  // a pair for each product
    bool squares = true;
#pragma unroll
    for (int k = 0; k < n; k++) squares = squares && !p[C + k].b;
    const u32 mine = split ? tm.t >> 1 : tm.t;
    u32 a[8], b[8], r[8];
#pragma unroll
    for (int w = 0; w < 8; w++) {
        const Prod& last = p[C + n - 1];
        a[w] = last.a[w];
        b[w] = last.b ? last.b[w] : last.a[w];
#pragma unroll
        for (int k = n - 2; k >= 0; k--) {
            const Prod& q = p[C + k];
            a[w] = mine == (u32)k ? q.a[w] : a[w];
            b[w] = mine == (u32)k ? (q.b ? q.b[w] : q.a[w]) : b[w];
        }
    }
    if (squares) fe_sqr(r, a);
    else if constexpr (split) fe_mul_pair(tm.mask, tm.t & 1u, r, a, b);
    else fe_mul(r, a, b);
    if constexpr (n == 1) {
        fe_copy(p[C].out, r);
    } else {
#pragma unroll
        for (int k = 0; k < n; k++) {
#pragma unroll
            for (int w = 0; w < 8; w++)
                p[C + k].out[w] = __shfl_sync(tm.mask, r[w], split ? 2 * k : k, T);
        }
    }
    if constexpr (C + T < N) level<L, N, C + T>(tm, p);
}

// r = K a (mod p), lazy, for a small constant K: the 9-word product (the
// high halves K a_i >> 32 first, then one carry chain of the low halves),
// its top word t8 < K folded as 2^256 = 2^32 + 977 (t8 977 < 2^32); a
// carry out of that fold leaves r below K (2^32 + 977), so the second fold
// ends at word 1, as in fe_add. One chain as long as fe_add's, for 2a,
// 3a, 4a, 6a, 8a that took fe_add one to three chains. Model:
// PairField.small.
template <u32 K>
__device__ __forceinline__ void fe_small(u32 r[8], const u32 a[8]) {
    u32 h[8];
#pragma unroll
    for (int i = 0; i < 8; i++) h[i] = __umulhi(a[i], K);
    u32 t[8];
    t[0] = mad_lo_cc(a[0], K, 0u);
#pragma unroll
    for (int i = 1; i < 8; i++) t[i] = madc_lo_cc(a[i], K, h[i - 1]);
    const u32 t8 = addc(h[7], 0u);
    r[0] = mad_lo_cc(t8, kFold, t[0]);
    r[1] = addc_cc(t[1], t8);
#pragma unroll
    for (int i = 2; i < 8; i++) r[i] = addc_cc(t[i], 0u);
    const u32 c = addc(0u, 0u);
    r[0] = mad_lo_cc(c, kFold, r[0]);
    r[1] = addc(r[1], c);
}

// ---- points, for a pair team ----------------------------------------------
// The formulas of secp256k1_core.cuh (the JAX ones: the same products in
// the same levels, the same values mod p), with their linear steps
// regrouped so that fewer wait on each other: small multiples by
// fe_small, and X3 and the next multiplier formed side by side from the
// level's outputs (the doubling's D (X3 = F - 2D, D - X3) from u = D / 2
// as F - 4u and 6u - F; the adds' X3 = R^2 - HHH - 2V and V - X3 =
// 3V + HHH - R^2 each from two independent steps). The degen flag is the
// same H == 0 test.

// Model: pair_call(F, L, "pt_double", ...).
template <int L>
__device__ __forceinline__ void pt_double(const PairTeam<L>& tm, u32 X[8], u32 Y[8], u32 Z[8]) {
    u32 A[8], B[8], YZ[8], C[8], D[8], E[8], F[8], t[8], u[8], V4[8], V6[8], W[8];
    level(tm, {Prod{A, X, nullptr}, Prod{B, Y, nullptr}, Prod{YZ, Y, Z}});
    fe_add(t, X, B);
    fe_small<3>(E, A);        // E = 3A
    level(tm, {Prod{C, B, nullptr}, Prod{D, t, nullptr}, Prod{F, E, nullptr}});
    fe_add(t, A, C);
    fe_sub(u, D, t);          // u = (X + B)^2 - A - C = D / 2
    fe_small<4>(V4, u);
    fe_small<6>(V6, u);
    fe_sub(X, F, V4);         // X3 = F - 2D
    fe_sub(t, V6, F);         // D - X3
    level(tm, {Prod{W, E, t}});  // E (D - X3)
    fe_small<8>(C, C);        // 8C
    fe_sub(Y, W, C);          // Y3 = E (D - X3) - 8C
    fe_small<2>(Z, YZ);       // Z3 = 2YZ
}

// Model: pair_call(F, L, "pt_add_mixed", ...).
template <int L>
__device__ __forceinline__ bool pt_add_mixed(const PairTeam<L>& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                             const u32 qx[8], const u32 qy[8]) {
    u32 Z1Z1[8], U2[8], ZZ1[8], S2[8], H[8], R[8], HH[8], Z3[8], HHH[8], V[8], RR[8], s[8],
        w[8], t[8], W[8], YH[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}});
    level(tm, {Prod{U2, qx, Z1Z1}, Prod{ZZ1, Z, Z1Z1}});
    fe_sub(H, U2, X);
    level(tm, {Prod{S2, qy, ZZ1}, Prod{Z3, Z, H}, Prod{HH, H, nullptr}});
    fe_sub(R, S2, Y);
    const bool hz = fe_is_zero(H);
    level(tm, {Prod{HHH, H, HH}, Prod{V, X, HH}, Prod{RR, R, nullptr}});
    fe_sub(s, RR, HHH);
    fe_small<2>(w, V);
    fe_sub(X, s, w);          // X3 = R^2 - (HHH + 2V)
    fe_sub(s, HHH, RR);
    fe_small<3>(w, V);
    fe_add(t, w, s);          // V - X3
    level(tm, {Prod{W, R, t}, Prod{YH, Y, HHH}});
    fe_sub(Y, W, YH);         // Y3 = R (V - X3) - Y HHH
    fe_copy(Z, Z3);           // Z3 = Z H
    return hz;
}

// Model: pair_call(F, L, "pt_add_full", ...).
template <int L>
__device__ __forceinline__ bool pt_add_full(const PairTeam<L>& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                            const u32 X2[8], const u32 Y2[8], const u32 Z2[8]) {
    u32 Z1Z1[8], Z2Z2[8], U1[8], U2[8], ZZ1[8], ZZ2[8], S1[8], S2[8], H[8], R[8], HH[8],
        HHH[8], V[8], Z12[8], RR[8], s[8], w[8], t[8], W[8], SH[8], Z3[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}, Prod{Z2Z2, Z2, nullptr}});
    level(tm, {Prod{U1, X, Z2Z2}, Prod{U2, X2, Z1Z1}, Prod{ZZ2, Z2, Z2Z2},
               Prod{ZZ1, Z, Z1Z1}});
    fe_sub(H, U2, U1);
    level(tm, {Prod{S1, Y, ZZ2}, Prod{S2, Y2, ZZ1}, Prod{HH, H, nullptr}});
    fe_sub(R, S2, S1);
    const bool hz = fe_is_zero(H);
    level(tm, {Prod{HHH, H, HH}, Prod{V, U1, HH}, Prod{Z12, Z, Z2}, Prod{RR, R, nullptr}});
    fe_sub(s, RR, HHH);
    fe_small<2>(w, V);
    fe_sub(X, s, w);          // X3 = R^2 - (HHH + 2V)
    fe_sub(s, HHH, RR);
    fe_small<3>(w, V);
    fe_add(t, w, s);          // V - X3
    level(tm, {Prod{W, R, t}, Prod{SH, S1, HHH}, Prod{Z3, Z12, H}});
    fe_sub(Y, W, SH);         // Y3 = R (V - X3) - S1 HHH
    fe_copy(Z, Z3);           // Z3 = Z1 Z2 H
    return hz;
}

// Whether a team type is a pair team.
template <class TM>
struct IsPairTeam {
    static constexpr bool value = false;
};
template <int L>
struct IsPairTeam<PairTeam<L>> {
    static constexpr bool value = true;
};

// Threads a lane of a team type.
template <class TM>
struct TeamSize;
template <int T>
struct TeamSize<Team<T>> {
    static constexpr int value = T;
};
template <int L>
struct TeamSize<PairTeam<L>> {
    static constexpr int value = 2 * L;
};

}  // namespace
