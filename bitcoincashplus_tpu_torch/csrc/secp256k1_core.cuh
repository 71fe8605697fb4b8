// The secp256k1 field core and point formulas shared by the ECDSA verify
// kernels of this directory (w4_verify.cu, glv_verify.cu, glv_pair.cu,
// ladder_verify.cu) and the MSM (msm.cu), for sm_90a.
//
// Field elements are 8 x 32-bit little-endian words holding lazy values:
// any word pattern in [0, 2^256) congruent to the field value mod
// p = 2^256 - 2^32 - 977. Products run on PTX carry chains; the point
// formulas are split into levels of independent field products that a
// team of T threads of one lane shares (see level<T, N>). The JAX
// schedule of each formula is kept, so the degen plane of a kernel built
// on them matches the JAX package's lane for lane.
//
// The CPU model of the field core and of the team schedule is
// tests/test_torch_w4_design.py; each function below names its model.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

namespace {

constexpr u32 kFold = 977u;        // 2^256 == 2^32 + 977 (mod p)

// ---- PTX carry-chain primitives ---------------------------------------------
// One PTX instruction each. The carry flag (CC) flows from one call to the
// next: a chain is a run of consecutive calls with no other carry user in
// between (volatile asm keeps their order). Model: class Ptx.

__device__ __forceinline__ u32 add_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 sub_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc(u32 a, u32 b) {
    u32 r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 mad_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 mad_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_hi(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// ---- field arithmetic mod p = 2^256 - 2^32 - 977 (lazy values) --------------

__device__ __forceinline__ void fe_copy(u32 r[8], const u32 a[8]) {
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = a[i];
}

__device__ __forceinline__ void fe_set_small(u32 r[8], u32 v) {
    r[0] = v;
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = 0u;
}

// t = a * b, exact (t < 2^512). Row i adds a * b[i] at word i in two
// accumulators: ev the products of a's even words (row i: words i .. i+7,
// carry into the fresh word i+8), od those of its odd words (words
// i+1 .. i+8, carry into i+9). The two chains of a row are independent.
// The last odd row cannot carry out: od <= a * b < 2^512.
// Model: Field.mul512.
__device__ __forceinline__ void mul512(u32 t[16], const u32 a[8], const u32 b[8]) {
    u32 ev[16], od[16];
#pragma unroll
    for (int k = 0; k < 16; k++) {
        ev[k] = 0u;
        od[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < 8; i++) {
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
        if (i + 9 < 16) od[i + 9] = addc(0u, 0u);
    }
    t[0] = ev[0];
    t[1] = add_cc(ev[1], od[1]);
#pragma unroll
    for (int k = 2; k < 15; k++) t[k] = addc_cc(ev[k], od[k]);
    t[15] = addc(ev[15], od[15]);  // a * b < 2^512: no carry out
}

// t = a^2, exact: the 28 cross products a[i] a[j] (i < j) by the rows of
// mul512 restricted to j > i (the same fresh carry words), summed, doubled
// by funnel shifts, plus the 8 squares a[i]^2 at word 2i in one chain.
// Model: Field.sqr512.
__device__ __forceinline__ void sqr512(u32 t[16], const u32 a[8]) {
    u32 ev[16], od[16];
#pragma unroll
    for (int k = 0; k < 16; k++) {
        ev[k] = 0u;
        od[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < 7; i++) {
        const int je = (i + 2) & ~1;  // the first even j > i
        if (je <= 6) {
            ev[i + je] = mad_lo_cc(a[je], a[i], ev[i + je]);
            ev[i + je + 1] = madc_hi_cc(a[je], a[i], ev[i + je + 1]);
#pragma unroll
            for (int j = je + 2; j <= 6; j += 2) {
                ev[i + j] = madc_lo_cc(a[j], a[i], ev[i + j]);
                ev[i + j + 1] = madc_hi_cc(a[j], a[i], ev[i + j + 1]);
            }
            ev[i + 8] = addc(0u, 0u);
        }
        const int jo = (i + 1) | 1;  // the first odd j > i
        od[i + jo] = mad_lo_cc(a[jo], a[i], od[i + jo]);
        od[i + jo + 1] = madc_hi_cc(a[jo], a[i], od[i + jo + 1]);
#pragma unroll
        for (int j = jo + 2; j <= 7; j += 2) {
            od[i + j] = madc_lo_cc(a[j], a[i], od[i + j]);
            od[i + j + 1] = madc_hi_cc(a[j], a[i], od[i + j + 1]);
        }
        od[i + 9] = addc(0u, 0u);
    }
    // x = the cross sum < 2^511 (word 0 is 0, ev[1] is 0): no carry out
    u32 x[16];
    x[0] = 0u;
    x[1] = od[1];
    x[2] = add_cc(ev[2], od[2]);
#pragma unroll
    for (int k = 3; k < 15; k++) x[k] = addc_cc(ev[k], od[k]);
    x[15] = addc(ev[15], od[15]);
    // t = 2x + sum a[i]^2 2^(64 i) = a^2 < 2^512: no carry out
    t[0] = mad_lo_cc(a[0], a[0], 0u);
    t[1] = madc_hi_cc(a[0], a[0], x[1] << 1);
#pragma unroll
    for (int i = 1; i < 8; i++) {
        const u32 d0 = __funnelshift_l(x[2 * i - 1], x[2 * i], 1);
        const u32 d1 = __funnelshift_l(x[2 * i], x[2 * i + 1], 1);
        t[2 * i] = madc_lo_cc(a[i], a[i], d0);
        t[2 * i + 1] = i < 7 ? madc_hi_cc(a[i], a[i], d1) : madc_hi(a[i], a[i], d1);
    }
}

// r = t mod p, lazy (r < 2^256), for any t < 2^512. With lo = t[0..7],
// hi = t[8..15]:
//   fold 1: v = lo + hi * 977 + hi * 2^32 in two chains (the low halves of
//           hi[i] * 977 at word i; their high halves plus hi[i] at word
//           i + 1), then summed; v < (2^256 - 1)(2^32 + 978), so its top
//           c = r8 + 2^32 r9 < 2^32 + 978: r9 <= 1, and r9 = 1 only with
//           r8 <= 977;
//   fold 2: v = v mod 2^256 + c (2^32 + 977), m = c (2^32 + 977) < 2^65 as
//           three words (k1 = r8 + 977 r9 < 2^32 by the bound above);
//   fold 3: a carry out of fold 2 leaves r < m < 2^65, so adding
//           2^32 + 977 once more ends within word 2.
// Model: Field.reduce512.
__device__ __forceinline__ void reduce512(u32 r[8], const u32 t[16]) {
    r[0] = mad_lo_cc(t[8], kFold, t[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = madc_lo_cc(t[8 + i], kFold, t[i]);
    u32 r8 = addc(0u, 0u);
    u32 s[9];
    s[1] = mad_hi_cc(t[8], kFold, t[8]);
#pragma unroll
    for (int i = 2; i < 9; i++) s[i] = madc_hi_cc(t[7 + i], kFold, t[7 + i]);
    const u32 s9 = addc(0u, 0u);
    r[1] = add_cc(r[1], s[1]);
#pragma unroll
    for (int i = 2; i < 8; i++) r[i] = addc_cc(r[i], s[i]);
    r8 = addc_cc(r8, s[8]);
    const u32 r9 = addc(s9, 0u);
    const u32 m0 = r8 * kFold;
    const u32 k1 = r9 * kFold + r8;
    const u32 m1 = mad_hi_cc(r8, kFold, k1);
    const u32 m2 = addc(r9, 0u);
    r[0] = add_cc(r[0], m0);
    r[1] = addc_cc(r[1], m1);
    r[2] = addc_cc(r[2], m2);
#pragma unroll
    for (int i = 3; i < 8; i++) r[i] = addc_cc(r[i], 0u);
    const u32 c2 = addc(0u, 0u);
    r[0] = mad_lo_cc(c2, kFold, r[0]);
    r[1] = addc_cc(r[1], c2);
    r[2] = addc(r[2], 0u);
}

// Model: Field.mul.
__device__ __forceinline__ void fe_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
    u32 t[16];
    mul512(t, a, b);
    reduce512(r, t);
}

// Model: Field.sqr.
__device__ __forceinline__ void fe_sqr(u32 r[8], const u32 a[8]) {
    u32 t[16];
    sqr512(t, a);
    reduce512(r, t);
}

// r = a + b, lazy. A carry out of 2^256 folds in as 2^32 + 977; that can
// carry once more only when the wrapped sum was within 2^32 + 977 of
// 2^256, and then the result is below 2^33: the second fold ends at word 1.
// Model: Field.add.
__device__ __forceinline__ void fe_add(u32 r[8], const u32 a[8], const u32 b[8]) {
    r[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = addc_cc(a[i], b[i]);
    u32 c = addc(0u, 0u);
    r[0] = mad_lo_cc(c, kFold, r[0]);
    r[1] = addc_cc(r[1], c);
#pragma unroll
    for (int i = 2; i < 8; i++) r[i] = addc_cc(r[i], 0u);
    c = addc(0u, 0u);
    r[0] = mad_lo_cc(c, kFold, r[0]);
    r[1] = addc(r[1], c);
}

// r = a - b, lazy. A borrow means r holds a - b + 2^256: subtract
// 2^32 + 977. That borrows again only when the wrapped value was below
// 2^32 + 977, leaving r >= 2^256 - 2^32 - 976 (word 1 >= 0xFFFFFFFE): the
// second subtraction ends at word 1.
// Model: Field.sub.
__device__ __forceinline__ void fe_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
    r[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = subc_cc(a[i], b[i]);
    u32 bw = subc(0u, 0u);  // 0 or 0xFFFFFFFF
    u32 m0 = bw & kFold, m1 = bw & 1u;
    r[0] = sub_cc(r[0], m0);
    r[1] = subc_cc(r[1], m1);
#pragma unroll
    for (int i = 2; i < 8; i++) r[i] = subc_cc(r[i], 0u);
    bw = subc(0u, 0u);
    m0 = bw & kFold;
    m1 = bw & 1u;
    r[0] = sub_cc(r[0], m0);
    r[1] = subc(r[1], m1);
}

// a == 0 (mod p) for a lazy a < 2^256 < 2p: a is 0 or p.
// Model: Field.is_zero.
__device__ __forceinline__ bool fe_is_zero(const u32 a[8]) {
    u32 z = 0u;
    u32 np = (a[0] ^ 0xFFFFFC2Fu) | (a[1] ^ 0xFFFFFFFEu);
#pragma unroll
    for (int i = 0; i < 8; i++) z |= a[i];
#pragma unroll
    for (int i = 2; i < 8; i++) np |= ~a[i];
    return z == 0u || np == 0u;
}

// r = a mod p in [0, p): a >= p exactly when a + 2^32 + 977 carries out
// of 2^256, and then the wrapped sum is a - p. Model: Field.canon.
__device__ __forceinline__ void fe_canon(u32 r[8], const u32 a[8]) {
    u32 s[8];
    s[0] = add_cc(a[0], kFold);
    s[1] = addc_cc(a[1], 1u);
#pragma unroll
    for (int i = 2; i < 8; i++) s[i] = addc_cc(a[i], 0u);
    const bool take = addc(0u, 0u) != 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = take ? s[i] : a[i];
}

// a == b (mod p), on canonical values. Model: Field.eq.
__device__ __forceinline__ bool fe_eq(const u32 a[8], const u32 b[8]) {
    u32 ca[8], cb[8];
    fe_canon(ca, a);
    fe_canon(cb, b);
    u32 acc = 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) acc |= ca[i] ^ cb[i];
    return acc == 0u;
}

// ---- the team: T threads of one lane -----------------------------------------

template <int T>
struct Team {
    u32 t;     // this thread's index in its team, 0 .. T-1
    u32 mask;  // the team's threads in the warp (T consecutive lanes)
};

template <int T>
__device__ __forceinline__ Team<T> make_team() {
    const u32 warp_lane = threadIdx.x & 31u;
    const u32 first = warp_lane & ~(u32)(T - 1);
    return Team<T>{warp_lane - first, ((1u << T) - 1u) << first};
}

// One field product of a level: out = a * b, or out = a^2 where b is null.
struct Prod {
    u32* out;
    const u32* a;
    const u32* b;
};

// One level: N independent products, inputs ready in every team thread.
// T = 1 runs them in order (squares by fe_sqr). T > 1 runs them in rounds
// of up to T: thread t computes product min(t, n - 1) of the round (fe_sqr
// when every product of the round is a square, else fe_mul with a square
// as a * a), and every thread receives the n results by __shfl_sync within
// the team. A round of one product needs no exchange: every thread computed
// it. Outputs must not alias inputs of the same level. Model: run_level.
template <int T, int N>
__device__ __forceinline__ void level(const Team<T>& tm, const Prod (&p)[N]) {
    if constexpr (T == 1) {
#pragma unroll
        for (int k = 0; k < N; k++) {
            if (p[k].b) fe_mul(p[k].out, p[k].a, p[k].b);
            else fe_sqr(p[k].out, p[k].a);
        }
    } else {
#pragma unroll
        for (int c = 0; c < N; c += T) {
            const int n = N - c < T ? N - c : T;
            bool squares = true;
#pragma unroll
            for (int k = 0; k < n; k++) squares = squares && !p[c + k].b;
            u32 a[8], b[8], r[8];
#pragma unroll
            for (int w = 0; w < 8; w++) {
                const Prod& last = p[c + n - 1];
                a[w] = last.a[w];
                b[w] = last.b ? last.b[w] : last.a[w];
#pragma unroll
                for (int k = n - 2; k >= 0; k--) {
                    const Prod& q = p[c + k];
                    a[w] = tm.t == (u32)k ? q.a[w] : a[w];
                    b[w] = tm.t == (u32)k ? (q.b ? q.b[w] : q.a[w]) : b[w];
                }
            }
            if (squares) fe_sqr(r, a);
            else fe_mul(r, a, b);
            if (n == 1) {
                fe_copy(p[c].out, r);
            } else {
#pragma unroll
                for (int k = 0; k < n; k++) {
#pragma unroll
                    for (int w = 0; w < 8; w++)
                        p[c + k].out[w] = __shfl_sync(tm.mask, r[w], k, T);
                }
            }
        }
    }
}

// ---- points (Jacobian; infinity is a separate flag) -------------------------
// Each formula is a sequence of levels of independent products; the linear
// steps between them run in every team thread. The team type (Team<T>, or
// secp256k1_pair.cuh's PairTeam<L>) picks the level that runs them.

// dbl-2009-l, a = 0: the JAX pt_double. Doubling a finite point never
// reaches infinity on secp256k1 (no 2-torsion). Model: pt_double.
template <class TM>
__device__ __forceinline__ void pt_double(const TM& tm, u32 X[8], u32 Y[8], u32 Z[8]) {
    u32 A[8], B[8], YZ[8], C[8], D[8], E[8], F[8], t[8], X3[8], W[8];
    level(tm, {Prod{A, X, nullptr}, Prod{B, Y, nullptr}, Prod{YZ, Y, Z}});
    fe_add(t, X, B);
    fe_add(E, A, A);
    fe_add(E, E, A);          // E = 3A
    level(tm, {Prod{C, B, nullptr}, Prod{D, t, nullptr}, Prod{F, E, nullptr}});
    fe_add(t, A, C);
    fe_sub(D, D, t);
    fe_add(D, D, D);          // D = 2((X + B)^2 - A - C)
    fe_add(t, D, D);
    fe_sub(X3, F, t);         // X3 = F - 2D
    fe_sub(t, D, X3);
    level(tm, {Prod{W, E, t}});  // E (D - X3)
    fe_add(C, C, C);
    fe_add(C, C, C);
    fe_add(C, C, C);          // 8C
    fe_sub(Y, W, C);          // Y3 = E (D - X3) - 8C
    fe_add(Z, YZ, YZ);        // Z3 = 2YZ
    fe_copy(X, X3);
}

// Cheap mixed add (X, Y, Z) += (qx, qy), both finite, without the
// same/opposite case analysis. Returns the H == 0 flag (the caller's
// degen signal). Model: pt_add_mixed.
template <class TM>
__device__ __forceinline__ bool pt_add_mixed(const TM& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                             const u32 qx[8], const u32 qy[8]) {
    u32 Z1Z1[8], U2[8], ZZ1[8], S2[8], H[8], R[8], HH[8], Z3[8], HHH[8], V[8], RR[8],
        t[8], X3[8], W[8], YH[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}});
    level(tm, {Prod{U2, qx, Z1Z1}, Prod{ZZ1, Z, Z1Z1}});
    fe_sub(H, U2, X);
    level(tm, {Prod{S2, qy, ZZ1}, Prod{Z3, Z, H}, Prod{HH, H, nullptr}});
    fe_sub(R, S2, Y);
    const bool hz = fe_is_zero(H);
    level(tm, {Prod{HHH, H, HH}, Prod{V, X, HH}, Prod{RR, R, nullptr}});
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sub(X3, RR, t);        // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, X3);
    level(tm, {Prod{W, R, t}, Prod{YH, Y, HHH}});
    fe_sub(Y, W, YH);         // Y3 = R (V - X3) - Y HHH
    fe_copy(X, X3);
    fe_copy(Z, Z3);           // Z3 = Z H
    return hz;
}

// Cheap full Jacobian add (X, Y, Z) += (X2, Y2, Z2), both finite; same
// contract as above. Model: pt_add_full.
template <class TM>
__device__ __forceinline__ bool pt_add_full(const TM& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                            const u32 X2[8], const u32 Y2[8], const u32 Z2[8]) {
    u32 Z1Z1[8], Z2Z2[8], U1[8], U2[8], ZZ1[8], ZZ2[8], S1[8], S2[8], H[8], R[8], HH[8],
        HHH[8], V[8], Z12[8], RR[8], t[8], X3[8], W[8], SH[8], Z3[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}, Prod{Z2Z2, Z2, nullptr}});
    level(tm, {Prod{U1, X, Z2Z2}, Prod{U2, X2, Z1Z1}, Prod{ZZ2, Z2, Z2Z2},
               Prod{ZZ1, Z, Z1Z1}});
    fe_sub(H, U2, U1);
    level(tm, {Prod{S1, Y, ZZ2}, Prod{S2, Y2, ZZ1}, Prod{HH, H, nullptr}});
    fe_sub(R, S2, S1);
    const bool hz = fe_is_zero(H);
    level(tm, {Prod{HHH, H, HH}, Prod{V, U1, HH}, Prod{Z12, Z, Z2}, Prod{RR, R, nullptr}});
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sub(X3, RR, t);        // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, X3);
    level(tm, {Prod{W, R, t}, Prod{SH, S1, HHH}, Prod{Z3, Z12, H}});
    fe_sub(Y, W, SH);         // Y3 = R (V - X3) - S1 HHH
    fe_copy(X, X3);
    fe_copy(Z, Z3);           // Z3 = Z1 Z2 H
    return hz;
}

// ---- input decoding and table slots -----------------------------------------

// 32 big-endian bytes -> 8 little-endian words, reduced mod p.
__device__ __forceinline__ void fe_from_be32(u32 r[8], const uint8_t* b) {
    u32 w[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint8_t* q = b + 4 * (7 - i);
        w[i] = ((u32)q[0] << 24) | ((u32)q[1] << 16) | ((u32)q[2] << 8) | (u32)q[3];
    }
    fe_canon(r, w);
}

// 20 limbs of 13 bits at limb-major stride B -> 8 words, reduced mod p.
// Limbs are summed (not OR-ed), so a limb wider than 13 bits still means
// its full value at weight 2^(13 i).
__device__ __forceinline__ void fe_from_limbs13(u32 r[8], const u32* plane, int lane, int B) {
    uint64_t acc[10];
#pragma unroll
    for (int w = 0; w < 10; w++) acc[w] = 0;
#pragma unroll
    for (int i = 0; i < 20; i++) {
        const uint64_t v = (uint64_t)plane[(size_t)i * B + lane] << ((13 * i) & 31);
        acc[(13 * i) >> 5] += v & 0xFFFFFFFFull;
        acc[((13 * i) >> 5) + 1] += v >> 32;
    }
    u32 t[16];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        c += acc[i];
        t[i] = (u32)c;
        c >>= 32;
    }
#pragma unroll
    for (int i = 10; i < 16; i++) t[i] = 0u;
    u32 w[8];
    reduce512(w, t);  // t < 2^320
    fe_canon(r, w);
}

// A point's 24 words to / from shared memory (16-byte aligned).
__device__ __forceinline__ void st_point(u32* dst, const u32 X[8], const u32 Y[8], const u32 Z[8]) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(X[0], X[1], X[2], X[3]);
    d[1] = make_uint4(X[4], X[5], X[6], X[7]);
    d[2] = make_uint4(Y[0], Y[1], Y[2], Y[3]);
    d[3] = make_uint4(Y[4], Y[5], Y[6], Y[7]);
    d[4] = make_uint4(Z[0], Z[1], Z[2], Z[3]);
    d[5] = make_uint4(Z[4], Z[5], Z[6], Z[7]);
}

__device__ __forceinline__ void ld_fe(u32 r[8], const u32* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    const uint4 lo = s[0], hi = s[1];
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

}  // namespace
