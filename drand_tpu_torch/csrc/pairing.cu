// The batched BLS product check e(-g1, sig)·e(pk, H(m)) == 1 on Hopper:
// two kernels, one thread per lane (one check = two Miller pairs).
//
// K1 miller_loop_kernel replaces the JAX package's Miller-loop Pallas
// kernels, ops/pallas_pairing.py:_miller_kernel and its grid twin
// _miller_grid_kernel. The TPU walked the 63 iterations as a sequential
// grid axis with the state in VMEM scratch; here the loop runs inside the
// thread, with the add step only on the set bits of |x| (the flag table in
// the constant buffer). Line formulas are those of _dbl_step, _add_step
// and _lines_product (pallas_pairing.py:100-172), so the output f equals
// the JAX kernel's f, not only after the final exponentiation.
//
// K2 final_exp_verdict_kernel replaces, fused, the final-exponentiation
// Pallas kernels of pallas_pairing.py: _easy_kernel/_easy_grid_kernel,
// _pow_kernel/_pow_grid_kernel (five calls), _mul_frob1_kernel,
// _a4_kernel and _is_one_kernel (and their grid twins). The TPU split
// them because of Mosaic's VMEM and register limits; one thread holds the
// whole chain here. It writes the GT value (the CUBE of the canonical
// pairing, as final_exp_hard_bl and crypto.pairing.final_exponentiation
// (canonical=False) compute it) and the lane's verdict.
//
// miller_step_kernel replaces the prototype tools/proto_miller_grid.py:
// _miller_grid_kernel, the Miller loop as a grid of N_MILLER steps with f
// and T carried in VMEM scratch, which tested whether the loop body was too
// large for the TPU compiler's register allocation. Here one launch runs
// one iteration (K1's own miller_iteration) for every lane, f and T live in
// device memory between launches, the host passes each step's add flag,
// and the last step writes conj(f): the output equals K1's word for word,
// and ptxas's registers and spills of the one-iteration body stand beside
// K1's. Its state (f and T, 432 words a lane) is read and written once a
// step, a few hundred bytes against some 190 Fp products.
//
// Bound: integer multiply-adds (see fp.cuh); inputs and outputs are a few
// hundred bytes per lane. Design: one thread per lane, blocks of 32 lanes
// so that a bucket of 512 spreads over 16 SMs; state spills to local
// memory. Several threads per lane would fill the card; that is a later
// change.
//
// Layouts (int32 words of canonical Montgomery values, batch leading):
//   xp, yp (B, 2, 12)          G1 affine x / y, pair axis
//   q      (B, 2, 2, 2, 12)    G2 affine: pair, x/y, c0/c1
//   f, gt  (B, 2, 3, 2, 12)    Fp12 = c0 + c1·w, Fp6 = sum c_i v^i
//   ok     (B,)                1 iff the product is one
#include "fp.cuh"

#define NPAIRS 2
#define LANES_PER_BLOCK 32

struct G2Jac { Fp2 x, y, z; };
struct Line { Fp2 c0, c3, c5; };  // c0 + c3·w^3 + c5·w^5

FP_INL void load_fp(Fp& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = src[i];
}

FP_INL void store_fp(uint32_t* dst, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[i] = a.w[i];
}

// Small multiples by repeated addition (values stay canonical)
FP_INL void f2_mul3(Fp2& r, const Fp2& a) {
  Fp2 t;
  f2_dbl(t, a);
  f2_add(r, t, a);
}

// Jacobian doubling of T and the tangent line at P (pallas_pairing._dbl_step)
FP_FN void dbl_step(G2Jac& T, Line& l, const Fp& xp, const Fp& yp) {
  Fp2 X2, Y2, Z2, Z3, YZ3, lam, t, C_, D, E, F_, Xn, Yn, Zn;
  f2_sqr(X2, T.x);
  f2_sqr(Y2, T.y);
  f2_sqr(Z2, T.z);
  f2_mul(Z3, Z2, T.z);
  f2_mul(YZ3, T.y, Z3);
  f2_mul(lam, X2, Z2);
  f2_mul3(lam, lam);
  // c0 = xi·(2·YZ3·yp)
  f2_dbl(t, YZ3);
  f2_mul_fp(t, t, yp);
  f2_mul_by_xi(l.c0, t);
  // c5 = -(lam·xp)
  f2_mul_fp(t, lam, xp);
  f2_neg(l.c5, t);
  // c3 = 3·X^3 - 2·Y^2
  f2_mul(t, X2, T.x);
  f2_mul3(t, t);
  f2_dbl(l.c3, Y2);
  f2_sub(l.c3, t, l.c3);
  // C = Y2^2, D = 2((X + Y2)^2 - X2 - C), E = 3·X2, F = E^2
  f2_sqr(C_, Y2);
  f2_add(t, T.x, Y2);
  f2_sqr(t, t);
  f2_add(D, X2, C_);
  f2_sub(D, t, D);
  f2_dbl(D, D);
  f2_mul3(E, X2);
  f2_sqr(F_, E);
  // Xn = F - 2D, Yn = E(D - Xn) - 8C, Zn = 2·Y·Z
  f2_dbl(t, D);
  f2_sub(Xn, F_, t);
  f2_sub(t, D, Xn);
  f2_mul(Yn, E, t);
  f2_dbl(t, C_);
  f2_dbl(t, t);
  f2_dbl(t, t);
  f2_sub(Yn, Yn, t);
  f2_mul(Zn, T.y, T.z);
  f2_dbl(Zn, Zn);
  T.x = Xn;
  T.y = Yn;
  T.z = Zn;
}

// Mixed addition T + Q and the chord line at P (pallas_pairing._add_step)
FP_FN void add_step(G2Jac& T, Line& l, const Fp2& xq, const Fp2& yq,
                    const Fp& xp, const Fp& yp) {
  Fp2 Z2, Z3, U2, S2, H, M, HZ, t, HH, HHH, V, M2, Xn, Yn, Zn;
  f2_sqr(Z2, T.z);
  f2_mul(Z3, Z2, T.z);
  f2_mul(U2, xq, Z2);
  f2_mul(S2, yq, Z3);
  f2_sub(H, U2, T.x);
  f2_sub(M, S2, T.y);
  f2_mul(HZ, H, T.z);
  // c0 = xi·(HZ·yp), c5 = -(M·xp), c3 = M·xq - HZ·yq
  f2_mul_fp(t, HZ, yp);
  f2_mul_by_xi(l.c0, t);
  f2_mul_fp(t, M, xp);
  f2_neg(l.c5, t);
  f2_mul(l.c3, M, xq);
  f2_mul(t, HZ, yq);
  f2_sub(l.c3, l.c3, t);
  f2_sqr(HH, H);
  f2_mul(HHH, HH, H);
  f2_mul(V, T.x, HH);
  f2_sqr(M2, M);
  // Xn = M^2 - (HHH + 2V), Yn = M(V - Xn) - Y·HHH, Zn = Z·H
  f2_dbl(t, V);
  f2_add(t, HHH, t);
  f2_sub(Xn, M2, t);
  f2_sub(t, V, Xn);
  f2_mul(Yn, M, t);
  f2_mul(t, T.y, HHH);
  f2_sub(Yn, Yn, t);
  f2_mul(Zn, T.z, H);
  T.x = Xn;
  T.y = Yn;
  T.z = Zn;
}

// Product of two 035-sparse lines as a full Fp12 (pallas_pairing._lines_product)
FP_FN void lines_product(Fp12& L, const Line& a, const Line& b) {
  Fp2 pa[6], pb[6], m[6], t;
  pa[0] = a.c0; pa[1] = a.c3; pa[2] = a.c5;
  pb[0] = b.c0; pb[1] = b.c3; pb[2] = b.c5;
  f2_add(pa[3], a.c0, a.c3);
  f2_add(pa[4], a.c0, a.c5);
  f2_add(pa[5], a.c3, a.c5);
  f2_add(pb[3], b.c0, b.c3);
  f2_add(pb[4], b.c0, b.c5);
  f2_add(pb[5], b.c3, b.c5);
#pragma unroll 1
  for (int k = 0; k < 6; ++k) f2_mul(m[k], pa[k], pb[k]);
  // w^3: c0d3 + c3d0 ; w^5: c0d5 + c5d0 ; w^8 = xi·w^2: c3d5 + c5d3
  f2_add(t, m[0], m[1]);
  f2_sub(W_AT(L, 3), m[3], t);
  f2_add(t, m[0], m[2]);
  f2_sub(W_AT(L, 5), m[4], t);
  f2_add(t, m[1], m[2]);
  f2_sub(t, m[5], t);
  f2_mul_by_xi(W_AT(L, 2), t);
  // w^0: m0 + xi·m1 (w^6) ; w^4: xi·m2 (w^10) ; w^1: 0
  f2_mul_by_xi(t, m[1]);
  f2_add(W_AT(L, 0), m[0], t);
  f2_mul_by_xi(W_AT(L, 4), m[2]);
  f2_zero(W_AT(L, 1));
}

// T = Q (Z = 1) on both pairs, f = 1: the state before the first iteration
FP_INL void miller_init(Fp12& f, G2Jac* T, const Fp2* xq, const Fp2* yq) {
#pragma unroll
  for (int j = 0; j < NPAIRS; ++j) {
    T[j].x = xq[j];
    T[j].y = yq[j];
    f2_zero(T[j].z);
    fp_copy(T[j].z.c0, C.one);
  }
  f12_one(f);
}

// One iteration of the Miller loop: f^2 times the tangent lines, then, on
// a set bit of |x|, times the chord lines (K1's loop body; the step kernel
// runs one a launch)
FP_INL void miller_iteration(Fp12& f, G2Jac* T, const Fp* xp, const Fp* yp,
                             const Fp2* xq, const Fp2* yq, bool add) {
  Line l[NPAIRS];
  Fp12 L;
  f12_sqr(f, f);
#pragma unroll 1
  for (int j = 0; j < NPAIRS; ++j) dbl_step(T[j], l[j], xp[j], yp[j]);
  lines_product(L, l[0], l[1]);
  f12_mul(f, f, L);
  if (add) {
#pragma unroll 1
    for (int j = 0; j < NPAIRS; ++j)
      add_step(T[j], l[j], xq[j], yq[j], xp[j], yp[j]);
    lines_product(L, l[0], l[1]);
    f12_mul(f, f, L);
  }
}

FP_FN void miller_lane(Fp12& f, const Fp* xp, const Fp* yp, const Fp2* xq,
                       const Fp2* yq) {
  G2Jac T[NPAIRS];
  miller_init(f, T, xq, yq);
  for (uint32_t i = 0; i < C.n_miller; ++i)
    miller_iteration(f, T, xp, yp, xq, yq, C.miller_flags[i] != 0);
  f12_conj(f, f);  // x < 0
}

// m^(-|e|) for cyclotomic m, MSB-first; e = x (use_x) or x - 1
FP_FN void cyc_pow_neg(Fp12& r, const Fp12& m, bool use_x) {
  Fp12 base, acc;
  f12_conj(base, m);
  f12_one(acc);
  const uint32_t nbits = use_x ? C.n_x : C.n_xm1;
  for (uint32_t i = 0; i < nbits; ++i) {
    f12_cyclotomic_sqr(acc, acc);
    if (use_x ? C.bits_x[i] : C.bits_xm1[i]) f12_mul(acc, acc, base);
  }
  r = acc;
}

// Easy part, Hayashida hard part (the cube of the canonical pairing) and
// the == 1 verdict: pallas_pairing.final_exp_easy_bl and final_exp_hard_bl.
FP_FN bool final_exp_lane(Fp12& out, const Fp12& f) {
  Fp12 m, a, b, t;
  // easy: f1 = conj(f)·f^-1 ; m = frob(f1, 2)·f1
  f12_inv(t, f);
  f12_conj(a, f);
  f12_mul(a, a, t);
  f12_frobenius(m, a, 2);
  f12_mul(m, m, a);
  // a1 = m^-|x-1|, a2 = a1^-|x-1|
  cyc_pow_neg(a, m, false);
  cyc_pow_neg(a, a, false);
  // a3 = a2^-|x|·frob(a2, 1)
  cyc_pow_neg(b, a, true);
  f12_frobenius(t, a, 1);
  f12_mul(a, b, t);
  // a4 = (a3^-|x|)^-|x|·frob(a3, 2)·conj(a3)
  cyc_pow_neg(b, a, true);
  cyc_pow_neg(b, b, true);
  f12_frobenius(t, a, 2);
  f12_mul(b, b, t);
  f12_conj(t, a);
  f12_mul(b, b, t);
  // out = a4·(m·cyc_sqr(m))
  f12_cyclotomic_sqr(t, m);
  f12_mul(t, m, t);
  f12_mul(out, b, t);
  return f12_is_one(out);
}

FP_INL void load_f12(Fp12& r, const uint32_t* src) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h)
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      load_fp(r.c[h].c[i].c0, src + ((h * 3 + i) * 2 + 0) * NW);
      load_fp(r.c[h].c[i].c1, src + ((h * 3 + i) * 2 + 1) * NW);
    }
}

FP_INL void store_f12(uint32_t* dst, const Fp12& a) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h)
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      store_fp(dst + ((h * 3 + i) * 2 + 0) * NW, a.c[h].c[i].c0);
      store_fp(dst + ((h * 3 + i) * 2 + 1) * NW, a.c[h].c[i].c1);
    }
}

#define F12_WORDS (2 * 3 * 2 * NW)

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(LANES_PER_BLOCK)
miller_loop_kernel(const uint32_t* __restrict__ xp,
                   const uint32_t* __restrict__ yp,
                   const uint32_t* __restrict__ q, uint32_t* __restrict__ f,
                   int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fp px[NPAIRS], py[NPAIRS];
  Fp2 qx[NPAIRS], qy[NPAIRS];
#pragma unroll
  for (int j = 0; j < NPAIRS; ++j) {
    load_fp(px[j], xp + (lane * NPAIRS + j) * NW);
    load_fp(py[j], yp + (lane * NPAIRS + j) * NW);
    const uint32_t* qj = q + (lane * NPAIRS + j) * 4 * NW;
    load_fp(qx[j].c0, qj);
    load_fp(qx[j].c1, qj + NW);
    load_fp(qy[j].c0, qj + 2 * NW);
    load_fp(qy[j].c1, qj + 3 * NW);
  }
  Fp12 acc;
  miller_lane(acc, px, py, qx, qy);
  store_f12(f + lane * F12_WORDS, acc);
}

__global__ void __launch_bounds__(LANES_PER_BLOCK)
final_exp_verdict_kernel(const uint32_t* __restrict__ f,
                         uint32_t* __restrict__ gt, int32_t* __restrict__ ok,
                         int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fp12 in, out;
  load_f12(in, f + lane * F12_WORDS);
  const bool one = final_exp_lane(out, in);
  store_f12(gt + lane * F12_WORDS, out);
  ok[lane] = one ? 1 : 0;
}

#define T_WORDS (NPAIRS * 3 * 2 * NW)

// One Miller iteration for every lane; state f (n, F12_WORDS) and T (n,
// NPAIRS, 3, 2, 12) in device memory; `first` starts from T = Q, f = 1,
// `last` writes conj(f) to `out` instead of the state.
__global__ void __launch_bounds__(LANES_PER_BLOCK)
miller_step_kernel(const uint32_t* __restrict__ xp,
                   const uint32_t* __restrict__ yp,
                   const uint32_t* __restrict__ q, uint32_t* __restrict__ f_st,
                   uint32_t* __restrict__ t_st, uint32_t* __restrict__ out,
                   int n, int first, int add, int last) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fp px[NPAIRS], py[NPAIRS];
  Fp2 qx[NPAIRS], qy[NPAIRS];
#pragma unroll
  for (int j = 0; j < NPAIRS; ++j) {
    load_fp(px[j], xp + (lane * NPAIRS + j) * NW);
    load_fp(py[j], yp + (lane * NPAIRS + j) * NW);
    const uint32_t* qj = q + (lane * NPAIRS + j) * 4 * NW;
    load_fp(qx[j].c0, qj);
    load_fp(qx[j].c1, qj + NW);
    load_fp(qy[j].c0, qj + 2 * NW);
    load_fp(qy[j].c1, qj + 3 * NW);
  }
  Fp12 f;
  G2Jac T[NPAIRS];
  uint32_t* ts = t_st + lane * T_WORDS;
  if (first) {
    miller_init(f, T, qx, qy);
  } else {
    load_f12(f, f_st + lane * F12_WORDS);
#pragma unroll 1
    for (int j = 0; j < NPAIRS; ++j) {
      Fp2* c[3] = {&T[j].x, &T[j].y, &T[j].z};
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        load_fp(c[k]->c0, ts + ((j * 3 + k) * 2 + 0) * NW);
        load_fp(c[k]->c1, ts + ((j * 3 + k) * 2 + 1) * NW);
      }
    }
  }
  miller_iteration(f, T, px, py, qx, qy, add != 0);
  if (last) {
    f12_conj(f, f);  // x < 0
    store_f12(out + lane * F12_WORDS, f);
    return;
  }
  store_f12(f_st + lane * F12_WORDS, f);
#pragma unroll 1
  for (int j = 0; j < NPAIRS; ++j) {
    const Fp2* c[3] = {&T[j].x, &T[j].y, &T[j].z};
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      store_fp(ts + ((j * 3 + k) * 2 + 0) * NW, c[k]->c0);
      store_fp(ts + ((j * 3 + k) * 2 + 1) * NW, c[k]->c1);
    }
  }
}

static dim3 grid_for(int n) {
  return dim3((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
}

extern "C" int miller_loop_launch(const void* consts, int n_words,
                                  const void* xp, const void* yp,
                                  const void* q, void* f, int n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  miller_loop_kernel<<<grid_for(n), LANES_PER_BLOCK, 0, s>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)q,
      (uint32_t*)f, n);
  return (int)cudaGetLastError();
}

extern "C" int final_exp_verdict_launch(const void* consts, int n_words,
                                        const void* f, void* gt, void* ok,
                                        int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  final_exp_verdict_kernel<<<grid_for(n), LANES_PER_BLOCK, 0, s>>>(
      (const uint32_t*)f, (uint32_t*)gt, (int32_t*)ok, n);
  return (int)cudaGetLastError();
}

// One step of miller_step_kernel; the constant buffer is copied on the
// first step only (constant memory keeps it for the later ones).
extern "C" int miller_step_launch(const void* consts, int n_words,
                                  const void* xp, const void* yp,
                                  const void* q, void* f_state, void* t_state,
                                  void* out, int n, int first, int add,
                                  int last, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (first) {
    cudaError_t e = load_consts(consts, n_words, s);
    if (e != cudaSuccess) return (int)e;
  }
  miller_step_kernel<<<grid_for(n), LANES_PER_BLOCK, 0, s>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)q,
      (uint32_t*)f_state, (uint32_t*)t_state, (uint32_t*)out, n, first, add,
      last);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
