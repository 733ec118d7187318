// a = 0 Jacobian point arithmetic on G1 (over Fp) and G2 (over Fp2) for
// one thread per lane, on the tower of fp.cuh.
//
// Replaces the point formulas the JAX package's Pallas kernels trace
// (ops/curve.py pt_dbl / pt_add / pt_to_affine and
// ops/bl_curve.py pt_mul_bits_getter). The formulas, the order of the
// cases of the complete addition and the coordinates of the point at
// infinity (1, 1, 0) are those of ops/curve.py (the plain PyTorch
// version), so a Jacobian result agrees with it word for word. Where the
// TPU selected between computed cases on every lane, a thread here
// branches and computes only its own case.
//
// One template over the field type, with overloads of the field
// operations; every point function is out of line, as the tower is.
// Compiles as plain C++ too (see fp.cuh).
#pragma once
#include "fp.cuh"

// ---------------------------------------------------------------------------
// field overloads
// ---------------------------------------------------------------------------

FP_INL void fe_add(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
FP_INL void fe_add(Fp2& r, const Fp2& a, const Fp2& b) { f2_add(r, a, b); }
FP_INL void fe_sub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
FP_INL void fe_sub(Fp2& r, const Fp2& a, const Fp2& b) { f2_sub(r, a, b); }
FP_INL void fe_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
FP_INL void fe_mul(Fp2& r, const Fp2& a, const Fp2& b) { f2_mul(r, a, b); }
FP_INL void fe_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }
FP_INL void fe_sqr(Fp2& r, const Fp2& a) { f2_sqr(r, a); }
FP_INL void fe_inv(Fp& r, const Fp& a) { fp_inv(r, a); }
FP_INL void fe_inv(Fp2& r, const Fp2& a) { f2_inv(r, a); }
FP_INL void fe_one(Fp& r) { fp_copy(r, C.one); }
FP_INL void fe_one(Fp2& r) {
  fp_copy(r.c0, C.one);
  fp_zero(r.c1);
}
FP_INL void fe_zero(Fp& r) { fp_zero(r); }
FP_INL void fe_zero(Fp2& r) { f2_zero(r); }
FP_INL bool fe_is_zero(const Fp& a) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) d |= a.w[i];
  return d == 0u;
}
FP_INL bool fe_is_zero(const Fp2& a) {
  return fe_is_zero(a.c0) && fe_is_zero(a.c1);
}
template <class F>
FP_INL void fe_dbl(F& r, const F& a) { fe_add(r, a, a); }

// ---------------------------------------------------------------------------
// points
// ---------------------------------------------------------------------------

template <class F>
struct Jac {
  F x, y, z;
  uint32_t inf;  // 1 at infinity
};

template <class F>
FP_INL void pt_set_inf(Jac<F>& r) {
  fe_one(r.x);
  fe_one(r.y);
  fe_zero(r.z);
  r.inf = 1u;
}

// 2P (curve.pt_dbl); runs the formula on every lane, inf passes through
template <class F>
FP_FN void pt_dbl(Jac<F>& r, const Jac<F>& p) {
  F A, B, C_, D, E, t, X3, Y3, Z3;
  fe_sqr(A, p.x);
  fe_sqr(B, p.y);
  fe_add(t, p.x, B);
  fe_sqr(t, t);
  fe_sqr(C_, B);
  // D = 2((X + B)^2 - (A + C)), E = 3A
  fe_add(D, A, C_);
  fe_sub(D, t, D);
  fe_dbl(D, D);
  fe_dbl(E, A);
  fe_add(E, E, A);
  // X3 = E^2 - 2D
  fe_sqr(t, E);
  fe_dbl(X3, D);
  fe_sub(X3, t, X3);
  // Y3 = E(D - X3) - 8C
  fe_sub(t, D, X3);
  fe_mul(Y3, E, t);
  fe_dbl(t, C_);
  fe_dbl(t, t);
  fe_dbl(t, t);
  fe_sub(Y3, Y3, t);
  // Z3 = 2YZ
  fe_mul(Z3, p.y, p.z);
  fe_dbl(Z3, Z3);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  r.inf = p.inf;
}

// Complete P + Q (curve.pt_add): an operand at infinity gives the other
// operand; H = 0 and S = 0 doubles P; H = 0 and S != 0 gives infinity.
template <class F>
FP_FN void pt_add(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
  if (p.inf) {
    r = q;
    return;
  }
  if (q.inf) {
    r = p;
    return;
  }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, Sd, t, I, J, rr, V, X3, Y3, Z3;
  fe_sqr(Z1Z1, p.z);
  fe_sqr(Z2Z2, q.z);
  fe_mul(U1, p.x, Z2Z2);
  fe_mul(U2, q.x, Z1Z1);
  fe_mul(t, p.y, q.z);
  fe_mul(S1, t, Z2Z2);
  fe_mul(t, q.y, p.z);
  fe_mul(S2, t, Z1Z1);
  fe_sub(H, U2, U1);
  fe_sub(Sd, S2, S1);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Sd))
      pt_dbl(r, p);
    else
      pt_set_inf(r);
    return;
  }
  // I = 4H^2, J = H·I, r = 2S, V = U1·I
  fe_dbl(rr, Sd);
  fe_sqr(I, H);
  fe_dbl(I, I);
  fe_dbl(I, I);
  fe_mul(J, H, I);
  fe_mul(V, U1, I);
  // X3 = r^2 - (J + 2V)
  fe_sqr(X3, rr);
  fe_dbl(t, V);
  fe_add(t, J, t);
  fe_sub(X3, X3, t);
  // Y3 = r(V - X3) - 2·S1·J
  fe_sub(t, V, X3);
  fe_mul(Y3, rr, t);
  fe_mul(t, S1, J);
  fe_dbl(t, t);
  fe_sub(Y3, Y3, t);
  // Z3 = ((Z1 + Z2)^2 - (Z1Z1 + Z2Z2))·H
  fe_add(t, p.z, q.z);
  fe_sqr(t, t);
  fe_add(Z3, Z1Z1, Z2Z2);
  fe_sub(t, t, Z3);
  fe_mul(Z3, t, H);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  r.inf = 0u;
}

// [k]P from infinity, MSB-first over nbits bits (bl_curve's ladder): every
// step doubles, a set bit adds P
template <class F>
FP_FN void pt_mul_bits(Jac<F>& r, const Jac<F>& p, const int32_t* bits,
                       int nbits) {
  Jac<F> acc;
  pt_set_inf(acc);
  for (int i = 0; i < nbits; ++i) {
    pt_dbl(acc, acc);
    if (bits[i]) pt_add(acc, acc, p);
  }
  r = acc;
}

// (X/Z^2, Y/Z^3) (curve.pt_to_affine); Z is taken as one at infinity
template <class F>
FP_FN void pt_to_affine(F& x, F& y, const Jac<F>& p) {
  F z, zi, zi2, zi3;
  if (p.inf)
    fe_one(z);
  else
    z = p.z;
  fe_inv(zi, z);
  fe_sqr(zi2, zi);
  fe_mul(x, p.x, zi2);
  fe_mul(zi3, zi2, zi);
  fe_mul(y, p.y, zi3);
}

FP_INL void load_fp(Fp& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = src[i];
}

FP_INL void store_fp(uint32_t* dst, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[i] = a.w[i];
}

FP_INL void load_f2(Fp2& r, const uint32_t* src) {
  load_fp(r.c0, src);
  load_fp(r.c1, src + NW);
}

FP_INL void store_f2(uint32_t* dst, const Fp2& a) {
  store_fp(dst, a.c0);
  store_fp(dst + NW, a.c1);
}
