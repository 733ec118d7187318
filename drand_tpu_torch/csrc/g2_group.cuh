// Cooperative G2 code on shared-memory slots, for the kernels that run a
// lane on a half-group of fp_group.cuh (GT = 4 threads holding each Fp
// value): K5 and K6 (csrc/h2c.cu) and the G2 MSM (csrc/msm.cu). Each of
// those sources includes this header once, with its own slot count and
// block size; no kernel carries a copy of the code below.
//
// Between operations each thread keeps its own words of every live Fp2
// value in shared memory, in a column of its own (no bank conflicts, no
// exchange through it). Each Fp2 operation is one small out-of-line
// function on slot numbers, straight line, with its operands in
// registers (gg_mul, gg_sqr2, ...). Point formulas, exponentiations and
// the [x] chain are inline sequences of those calls (gg_dbl, gg_pt_add,
// gg_inv, gg_mul_x, ...): loops and branches stay there, between calls.
//
// Three rules keep a warp fast, each worth several times (PERF.md, §6):
//  - every shuffle and ballot is over the whole converged warp (a mask
//    per half-group makes the hardware synchronise each mask group apart);
//  - no branch inside a function before a shuffle (ptxas cannot prove the
//    warp converged after it, and routes every later shuffle through a
//    divergence check and a synchronising slow path);
//  - a choice that depends on the thread's place is a mask loaded from
//    memory, never a condition (ptxas unswitches a loop on it and the
//    warp splits).
// So a branch on a lane's data runs where any lane of the warp takes it
// (gg_warp_any), and each lane then copies its own case's value, a copy
// holding no shuffle. A lane with nothing to do runs as another lane of
// its warp does and discards the result; no thread leaves early.
//
// The formulas and cases are curve.cuh's and fp.cuh's (pt_dbl, pt_add,
// pt_to_affine, f2_inv, psi, mul_x): a value computed here is the same
// integer as the one-thread tower computes.
//
// The includer defines, before including this header (after fp_group.cuh):
//   GG_BLOCK   threads of a block (one slot column each)
//   GG_SLOTS   Fp2 slots of a column; operand numbers from GG_SLOTS on
//              name constants
//   GG_DB      first of three slots: a complete addition's doubling case
//   GG_NORM, GG_RECIP  an inversion's norm and its inverse (c0 only)
//   GG_ONE     the operand number of the constant one
//   gg_ld_const(F2g&, int s, const Half&)  every other constant operand
// Slots 0..15 are the complete addition's temporaries (the enum below);
// a doubling uses 0..8, an exponentiation's window table 1..15, the
// to-affine 0..3. Compiles as plain C++ with GG_WARP_EMULATION, where the
// includer supplies gg_emulated_tid() and the warp intrinsics.
#pragma once
#include "fp_group.cuh"

#if defined(__CUDACC__)
#define GG_OP __device__ __noinline__
#define GG_SHARED __shared__
#define GG_TID ((uint32_t)threadIdx.x)
#else  // a host emulation of one warp supplies gg_emulated_tid()
#define GG_OP static
#define GG_SHARED static
#define GG_TID gg_emulated_tid()
#endif

// the complete addition's temporaries
enum : int {
  S_Z1Z1 = 0, S_Z2Z2, S_U1, S_U2, S_S1, S_S2, S_H, S_SD, S_TT, S_I, S_J,
  S_RR, S_V, S_X3, S_Y3, S_Z3, GG_TEMPS
};
static_assert(GG_TEMPS == 16 && GG_SLOTS > GG_DB + 2 && GG_SLOTS > GG_RECIP &&
              GG_ONE >= GG_SLOTS, "slot layout");

GG_SHARED uint32_t gg_slot[GG_SLOTS * 2 * GW * GG_BLOCK];
// each thread's words of p, then its masks Half::above and Half::below
GG_SHARED uint32_t gg_p[(GW + 2) * GG_BLOCK];

// The calling thread's words of p and shift masks, written once before
// its first operation (gg_half reads them back, see Half)
FG_INL void gg_init() {
  const uint32_t tid = GG_TID, k = tid % 32u % GT;
#pragma unroll
  for (int v = 0; v < GW; ++v) gg_p[v * GG_BLOCK + tid] = C.p.w[GW * k + v];
  gg_p[GW * GG_BLOCK + tid] = k == GT - 1 ? 0u : 0xFFFFFFFFu;
  gg_p[(GW + 1) * GG_BLOCK + tid] = k == 0 ? 0u : 0xFFFFFFFFu;
}

FG_INL Half gg_half() {
  Half h;
  const uint32_t tid = GG_TID;
  h.lane = tid % 32u;
  h.k = h.lane % GT;
  h.mask = ((1u << GT) - 1u) << (h.lane - h.k);
#pragma unroll
  for (int v = 0; v < GW; ++v) h.p[v] = gg_p[v * GG_BLOCK + tid];
  h.above = gg_p[GW * GG_BLOCK + tid];
  h.below = gg_p[(GW + 1) * GG_BLOCK + tid];
  return h;
}

// word v (c0's GW words, then c1's) of slot s in this thread's column
FG_INL uint32_t& gg_word(int s, int v) {
  return gg_slot[(s * 2 * GW + v) * GG_BLOCK + GG_TID];
}

FG_INL void gg_ld(F2g& r, int s, const Half& h) {
  if (s < GG_SLOTS) {
#pragma unroll
    for (int v = 0; v < GW; ++v) {
      r.c0.w[v] = gg_word(s, v);
      r.c1.w[v] = gg_word(s, GW + v);
    }
  } else if (s == GG_ONE) {
    fg_slice(r.c0, C.one, h);
    fg_zero(r.c1);
  } else {
    gg_ld_const(r, s, h);
  }
}

FG_INL void gg_st(int s, const F2g& a) {
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    gg_word(s, v) = a.c0.w[v];
    gg_word(s, GW + v) = a.c1.w[v];
  }
}

FG_INL void gg_copy(int d, int a) {
  F2g x;
  gg_ld(x, a, gg_half());
  gg_st(d, x);
}

FG_INL void gg_zero(int d) {
#pragma unroll
  for (int v = 0; v < 2 * GW; ++v) gg_word(d, v) = 0u;
}

// ---------------------------------------------------------------------------
// One Fp2 operation on slots, out of line: the straight-line formulas
// below are sequences of these calls, which keeps the kernels' code small.
// ---------------------------------------------------------------------------

GG_OP void gg_mul(int d, int a, int b) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, b, h);
  f2g_mul(x, x, y, h);
  gg_st(d, x);
}

GG_OP void gg_sqr(int d, int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  f2g_sqr(x, x, h);
  gg_st(d, x);
}

// two independent products, or squarings, side by side (their Fp
// products interleave); both results are stored after every load
GG_OP void gg_mul2(int d1, int a1, int b1, int d2, int a2, int b2) {
  const Half h = gg_half();
  F2g x[2], y[2];
  gg_ld(x[0], a1, h);
  gg_ld(y[0], b1, h);
  gg_ld(x[1], a2, h);
  gg_ld(y[1], b2, h);
  f2g_mul_n<2>(x, x, y, h);
  gg_st(d1, x[0]);
  gg_st(d2, x[1]);
}

GG_OP void gg_sqr2(int d1, int a1, int d2, int a2) {
  const Half h = gg_half();
  F2g x[2];
  gg_ld(x[0], a1, h);
  gg_ld(x[1], a2, h);
  f2g_sqr_n<2>(x, x, h);
  gg_st(d1, x[0]);
  gg_st(d2, x[1]);
}

GG_OP void gg_add(int d, int a, int b) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, b, h);
  f2g_add(x, x, y, h);
  gg_st(d, x);
}

GG_OP void gg_sub(int d, int a, int b) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, b, h);
  f2g_sub(x, x, y, h);
  gg_st(d, x);
}

GG_OP void gg_neg(int d, int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  f2g_neg(x, x, h);
  gg_st(d, x);
}

GG_OP void gg_conj(int d, int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  f2g_conj(x, x, h);
  gg_st(d, x);
}

// Fp products on the c0 words of slots: the steps of an inversion
GG_OP void gg_fmul(int d, int a, int b) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, b, h);
  fg_mul(x.c0, x.c0, y.c0, h);
  gg_st(d, x);
}

// c0 of D = a0^2 + a1^2, the norm of A
GG_OP void gg_norm(int d, int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  Fg p[2] = {x.c0, x.c1}, q[2] = {x.c0, x.c1}, n[2];
  fg_mul_n<2>(n, p, q, h);
  fg_add(x.c0, n[0], n[1], h);
  gg_st(d, x);
}

// D = (a0·t, -a1·t) with t the c0 of slot T
GG_OP void gg_scale_conj(int d, int a, int t) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, t, h);
  Fg p[2] = {x.c0, x.c1}, q[2] = {y.c0, y.c0}, n[2];
  fg_mul_n<2>(n, p, q, h);
  x.c0 = n[0];
  fg_neg(x.c1, n[1], h);
  gg_st(d, x);
}

GG_OP uint32_t gg_is_zero(int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  return f2g_is_zero(x, h);
}

GG_OP uint32_t gg_eq(int a, int b) {
  const Half h = gg_half();
  F2g x, y;
  gg_ld(x, a, h);
  gg_ld(y, b, h);
  return f2g_eq(x, y, h);
}

// RFC 9380 sgn0: sgn0(c0) | (c0 == 0 & sgn0(c1)), from the canonical
// integers (two products by the plain integer 1)
GG_OP uint32_t gg_sgn0(int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  Fg p[2] = {x.c0, x.c1}, one[2], c[2];
  fg_zero(one[0]);
  one[0].w[0] = ~h.below & 1u;
  one[1] = one[0];
  fg_mul_n<2>(c, p, one, h);
  const uint32_t zero0 = fg_is_zero(c[0], h);
  const uint32_t s0 = __shfl_sync(FG_WARP, c[0].w[0] & 1u, 0, GT);
  const uint32_t s1 = __shfl_sync(FG_WARP, c[1].w[0] & 1u, 0, GT);
  return s0 | (zero0 & s1);
}

// ---------------------------------------------------------------------------
// Sequences of slot operations
// ---------------------------------------------------------------------------

FG_INL uint32_t gg_warp_any(uint32_t pred) {
  return __any_sync(FG_WARP, pred ? 1 : 0) ? 1u : 0u;
}

// a^e into D by 4-bit fixed windows over the n bits of e (MSB first, the
// same on every thread), as fp.cuh's f2_pow_sqrt computes it: the table
// a^1..a^15 in slots 1..15 (a^k = a^(k-q)·a^q, q the largest power of two
// below k), then per window four squarings and, for a nonzero digit, one
// product.
FG_INL void gg_pow(int d, int a, const uint32_t* bits, int n) {
  gg_copy(1, a);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    int q = 1;
    while (2 * q < k) q *= 2;
    gg_mul(k, k - q, q);
  }
  const int lead = n % 4 == 0 ? 4 : n % 4;  // bits of the top window
  int dg = 0;
  for (int i = 0; i < lead; ++i) dg = 2 * dg + (int)bits[i];
  gg_copy(d, dg);
#pragma unroll 1
  for (int i = lead; i < n; i += 4) {
    dg = 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      gg_sqr(d, d);
      dg = 2 * dg + (int)bits[i + j];
    }
    if (dg) gg_mul(d, d, dg);
  }
}

// a1^e into D1 and a2^e into D2 side by side, as gg_pow computes each:
// the second table in slots TAB2 + 1..15
FG_INL void gg_pow2(int d1, int a1, int d2, int a2, int tab2,
                    const uint32_t* bits, int n) {
  gg_copy(1, a1);
  gg_copy(tab2 + 1, a2);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    int q = 1;
    while (2 * q < k) q *= 2;
    gg_mul2(k, k - q, q, tab2 + k, tab2 + k - q, tab2 + q);
  }
  const int lead = n % 4 == 0 ? 4 : n % 4;  // bits of the top window
  int dg = 0;
  for (int i = 0; i < lead; ++i) dg = 2 * dg + (int)bits[i];
  gg_copy(d1, dg);
  gg_copy(d2, tab2 + dg);
#pragma unroll 1
  for (int i = lead; i < n; i += 4) {
    dg = 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      gg_sqr2(d1, d1, d2, d2);
      dg = 2 * dg + (int)bits[i + j];
    }
    if (dg) gg_mul2(d1, d1, dg, d2, d2, tab2 + dg);
  }
}

// fp.cuh f2_inv into D: (a0 - a1·u) / (a0^2 + a1^2), the norm inverted
// by Fermat, a^(p-2), MSB-first square-and-multiply over the bits of p-2;
// one out-of-line product per step (a branch around the products inside
// one function would make ptxas synchronise the warp at every shuffle)
FG_INL void gg_inv(int d, int a) {
  gg_norm(GG_NORM, a);
  gg_copy(GG_RECIP, GG_ONE);
#pragma unroll 1
  for (uint32_t i = 0; i < C.n_pm2; ++i) {
    gg_fmul(GG_RECIP, GG_RECIP, GG_RECIP);
    if (C.pm2[i]) gg_fmul(GG_RECIP, GG_RECIP, GG_NORM);
  }
  gg_scale_conj(d, a, GG_RECIP);
}

// 2P (curve.cuh pt_dbl) from point slots A into D (which may be A), on
// temporaries 0..8 (an addition's first nine, dead whenever it doubles);
// independent products run side by side. The infinity flag passes
// through.
FG_INL void gg_dbl(int d, int a) {
  enum { A = 0, B, C_, D, E, T, X3, Y3, Z3 };
  gg_sqr2(A, a, B, a + 1);
  gg_add(T, a, B);
  gg_sqr2(T, T, C_, B);
  // D = 2((X + B)^2 - (A + C)), E = 3A
  gg_add(D, A, C_);
  gg_sub(D, T, D);
  gg_add(D, D, D);
  gg_add(E, A, A);
  gg_add(E, E, A);
  // X3 = E^2 - 2D
  gg_sqr(T, E);
  gg_add(X3, D, D);
  gg_sub(X3, T, X3);
  // Y3 = E(D - X3) - 8C, Z3 = 2YZ
  gg_sub(T, D, X3);
  gg_mul2(Y3, E, T, Z3, a + 1, a + 2);
  gg_add(T, C_, C_);
  gg_add(T, T, T);
  gg_add(T, T, T);
  gg_sub(Y3, Y3, T);
  gg_add(Z3, Z3, Z3);
  gg_copy(d, X3);
  gg_copy(d + 1, Y3);
  gg_copy(d + 2, Z3);
}

FG_INL void gg_copy3(int d, int a) {
  if (d == a) return;
  for (int i = 0; i < 3; ++i) gg_copy(d + i, a + i);
}

FG_INL void gg_pt_neg(int d, int a) {
  gg_copy(d, a);
  gg_neg(d + 1, a + 1);
  gg_copy(d + 2, a + 2);
}

// Complete P + Q (curve.cuh pt_add: the same formulas and cases) on point
// slots; returns the sum's infinity flag. R may be P or Q. The warp runs
// the general formula, and the doubling, where any of its lanes needs
// them (every shuffle inside needs the whole warp); each lane then
// copies its own case's result: Q where P is infinity, P where Q is, 2P
// where H = 0 and S = 0, infinity where H = 0 alone, else the sum.
FG_INL uint32_t gg_pt_add(int r, int p, uint32_t pinf, int q,
                          uint32_t qinf) {
  const uint32_t gen = !pinf && !qinf ? 1u : 0u;
  uint32_t hz = 0u, sz = 0u;
  if (gg_warp_any(gen)) {
    gg_sqr2(S_Z1Z1, p + 2, S_Z2Z2, q + 2);
    gg_mul2(S_U1, p, S_Z2Z2, S_U2, q, S_Z1Z1);
    gg_mul2(S_TT, p + 1, q + 2, S_S2, q + 1, p + 2);
    gg_mul2(S_S1, S_TT, S_Z2Z2, S_S2, S_S2, S_Z1Z1);
    gg_sub(S_H, S_U2, S_U1);
    gg_sub(S_SD, S_S2, S_S1);
    hz = gg_is_zero(S_H);
    sz = gg_is_zero(S_SD);
    if (gg_warp_any(gen & (hz ^ 1u))) {
      // I = 4H^2, J = H·I, r = 2S, V = U1·I
      gg_add(S_RR, S_SD, S_SD);
      gg_sqr(S_I, S_H);
      gg_add(S_I, S_I, S_I);
      gg_add(S_I, S_I, S_I);
      gg_mul2(S_J, S_H, S_I, S_V, S_U1, S_I);
      // X3 = r^2 - (J + 2V); beside r^2, (Z1 + Z2)^2 for Z3
      gg_add(S_Z3, p + 2, q + 2);
      gg_sqr2(S_X3, S_RR, S_Z3, S_Z3);
      gg_add(S_TT, S_V, S_V);
      gg_add(S_TT, S_J, S_TT);
      gg_sub(S_X3, S_X3, S_TT);
      // Y3 = r(V - X3) - 2·S1·J (S1·J into U2, dead)
      gg_sub(S_TT, S_V, S_X3);
      gg_mul2(S_Y3, S_RR, S_TT, S_U2, S_S1, S_J);
      gg_add(S_U2, S_U2, S_U2);
      gg_sub(S_Y3, S_Y3, S_U2);
      // Z3 = ((Z1 + Z2)^2 - (Z1Z1 + Z2Z2))·H
      gg_add(S_TT, S_Z1Z1, S_Z2Z2);
      gg_sub(S_TT, S_Z3, S_TT);
      gg_mul(S_Z3, S_TT, S_H);
    }
    if (gg_warp_any(gen & hz & sz)) gg_dbl(GG_DB, p);
  }
  if (pinf) {
    gg_copy3(r, q);
    return qinf;
  }
  if (qinf) {
    gg_copy3(r, p);
    return 0u;
  }
  if (hz && sz) {
    gg_copy3(r, GG_DB);
    return 0u;
  }
  if (hz) {
    gg_copy(r, GG_ONE);
    gg_copy(r + 1, GG_ONE);
    gg_zero(r + 2);
    return 1u;
  }
  gg_copy3(r, S_X3);
  return 0u;
}

// The sum of this group's point A (slots a, a+1, a+2; flag ainf) and the
// point of the group DIST lanes away (xor, in segments of WIDTH lanes),
// into A on both groups: each takes the other's point by shuffles, the
// lower group's point goes to A and the upper's to B (UPPER: 1 on the
// upper group), and both add them, so both hold the same value. Returns
// the sum's infinity flag.
FG_INL uint32_t gg_swap_add(int a, int b, uint32_t ainf, uint32_t upper,
                            int dist, int width) {
  const uint32_t oinf = __shfl_xor_sync(FG_WARP, ainf, dist, width);
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v) {
      const uint32_t own = gg_word(a + s, v);
      const uint32_t other = __shfl_xor_sync(FG_WARP, own, dist, width);
      gg_word(a + s, v) = upper ? other : own;
      gg_word(b + s, v) = upper ? own : other;
    }
  return gg_pt_add(a, a, upper ? oinf : ainf, b, upper ? ainf : oinf);
}

// psi(X, Y, Z) = (cx·conj(X), cy·conj(Y), conj(Z)) with the constant
// operands CX, CY; R may be P
FG_INL void gg_psi(int r, int p, int cx, int cy) {
  gg_conj(S_TT, p);
  gg_mul(r, S_TT, cx);
  gg_conj(S_TT, p + 1);
  gg_mul(r + 1, S_TT, cy);
  gg_conj(r + 2, p + 2);
}

// psi^2(X, Y, Z) = (cx·X, cy·Y, Z)
FG_INL void gg_psi2(int r, int p, int cx, int cy) {
  gg_mul(r, p, cx);
  gg_mul(r + 1, p + 1, cy);
  gg_copy(r + 2, p + 2);
}

// [x]P into R (not P) on the accumulator slots ACC; returns its infinity
// flag. x < 0: [|x|]P MSB first from P (the leading bit), 63 doublings
// and 5 additions, the same on every lane, then negated.
FG_INL uint32_t gg_mul_x(int r, int p, uint32_t pinf, int acc) {
  gg_copy3(acc, p);
  uint32_t ainf = pinf;
#pragma unroll 1
  for (uint32_t i = 1; i < C.n_x; ++i) {
    gg_dbl(acc, acc);
    if (C.bits_x[i]) ainf = gg_pt_add(acc, acc, ainf, p, pinf);
  }
  gg_pt_neg(r, acc);
  return ainf;
}

// (X/Z^2, Y/Z^3) into AX, AY; Z is taken as one at infinity
FG_INL void gg_affine(int ax, int ay, int p, uint32_t pinf) {
  gg_copy(0, pinf ? GG_ONE : p + 2);
  gg_inv(1, 0);
  gg_sqr(2, 1);
  gg_mul(ax, p, 2);
  gg_mul(3, 2, 1);
  gg_mul(ay, p + 1, 3);
}
