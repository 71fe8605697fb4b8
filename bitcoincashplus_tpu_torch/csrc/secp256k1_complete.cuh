// Complete point additions on the field core of secp256k1_core.cuh, for
// the Schnorr batch check (msm.cu).
//
// The JAX package's pt_add_mixed and pt_add_full (bitcoincashplus_tpu/ops/
// secp256k1.py:418 and :1808) resolve every case of the group law by
// selects: P = inf -> Q; Q = inf -> P; P == Q -> double(P); P == -Q ->
// infinity; else the madd / add-2007-bl formulas. Here the same case
// analysis is a branch: every input of a test (the inf flags, the H and R
// values) is held by every thread of a team, so a team always takes the
// same branch and its shuffles stay converged. The generic results keep
// the JAX formulas' values mod p (X3 = R^2 - (HHH + 2V), Y3 = R (V - X3) -
// S1 HHH, Z3 = Z1 Z2 H), so a sum built here has the same Jacobian triple
// mod p as the plain version's (ops/secp256k1.pt_add_mixed/pt_add_full).
//
// The zero tests are exact: H and R are outputs of fe_sub, whose result
// is a word pattern in [0, 2^256) (8 words, one or two folds of 2^32 +
// 977 on a borrow), and 2^256 < 2p, so H == 0 mod p exactly when H is 0
// or p — what fe_is_zero tests.
//
// The cheap adds of secp256k1_core.cuh (the w4 and GLV ladders, with
// their degen flag and host re-check) are not used here: the MSM has no
// host re-check of a lane, so every add must be right on its own.
//
// Infinity is a flag beside (X, Y, Z); the coordinates under it are
// never read.

#pragma once

#include "secp256k1_core.cuh"

namespace {

// (X, Y, Z, inf) += (qx, qy, qinf), Q affine. Model: ops/secp256k1.py
// pt_add_mixed.
template <class TM>
__device__ __forceinline__ void pt_add_mixed_complete(const TM& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                                      bool& inf, const u32 qx[8], const u32 qy[8],
                                                      bool qinf) {
    if (qinf) return;
    if (inf) {
        fe_copy(X, qx);
        fe_copy(Y, qy);
        fe_set_small(Z, 1u);
        inf = false;
        return;
    }
    u32 Z1Z1[8], U2[8], ZZ1[8], S2[8], H[8], R[8], HH[8], RR[8], Z3[8], HHH[8], V[8],
        t[8], X3[8], W[8], YH[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}});
    level(tm, {Prod{U2, qx, Z1Z1}, Prod{ZZ1, Z, Z1Z1}});
    level(tm, {Prod{S2, qy, ZZ1}});
    fe_sub(H, U2, X);
    fe_sub(R, S2, Y);
    if (fe_is_zero(H)) {
        if (fe_is_zero(R)) pt_double(tm, X, Y, Z);  // P == Q
        else inf = true;                             // P == -Q
        return;
    }
    level(tm, {Prod{HH, H, nullptr}, Prod{RR, R, nullptr}, Prod{Z3, Z, H}});
    level(tm, {Prod{HHH, H, HH}, Prod{V, X, HH}});
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sub(X3, RR, t);        // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, X3);
    level(tm, {Prod{W, R, t}, Prod{YH, Y, HHH}});
    fe_sub(Y, W, YH);         // Y3 = R (V - X3) - Y HHH
    fe_copy(X, X3);
    fe_copy(Z, Z3);           // Z3 = Z H
}

// (X, Y, Z, inf) += (X2, Y2, Z2, inf2), both Jacobian. Model:
// ops/secp256k1.py pt_add_full.
template <class TM>
__device__ __forceinline__ void pt_add_full_complete(const TM& tm, u32 X[8], u32 Y[8], u32 Z[8],
                                                     bool& inf, const u32 X2[8], const u32 Y2[8],
                                                     const u32 Z2[8], bool inf2) {
    if (inf2) return;
    if (inf) {
        fe_copy(X, X2);
        fe_copy(Y, Y2);
        fe_copy(Z, Z2);
        inf = false;
        return;
    }
    u32 Z1Z1[8], Z2Z2[8], U1[8], U2[8], ZZ1[8], ZZ2[8], S1[8], S2[8], H[8], R[8], HH[8],
        RR[8], Z12[8], HHH[8], V[8], Z3[8], t[8], X3[8], W[8], SH[8];
    level(tm, {Prod{Z1Z1, Z, nullptr}, Prod{Z2Z2, Z2, nullptr}});
    level(tm, {Prod{U1, X, Z2Z2}, Prod{U2, X2, Z1Z1}, Prod{ZZ2, Z2, Z2Z2},
               Prod{ZZ1, Z, Z1Z1}});
    level(tm, {Prod{S1, Y, ZZ2}, Prod{S2, Y2, ZZ1}});
    fe_sub(H, U2, U1);
    fe_sub(R, S2, S1);
    if (fe_is_zero(H)) {
        if (fe_is_zero(R)) pt_double(tm, X, Y, Z);  // P == Q
        else inf = true;                             // P == -Q
        return;
    }
    level(tm, {Prod{HH, H, nullptr}, Prod{RR, R, nullptr}, Prod{Z12, Z, Z2}});
    level(tm, {Prod{HHH, H, HH}, Prod{V, U1, HH}, Prod{Z3, Z12, H}});
    fe_add(t, V, V);
    fe_add(t, HHH, t);
    fe_sub(X3, RR, t);        // X3 = R^2 - (HHH + 2V)
    fe_sub(t, V, X3);
    level(tm, {Prod{W, R, t}, Prod{SH, S1, HHH}});
    fe_sub(Y, W, SH);         // Y3 = R (V - X3) - S1 HHH
    fe_copy(X, X3);
    fe_copy(Z, Z3);           // Z3 = Z1 Z2 H
}

}  // namespace
