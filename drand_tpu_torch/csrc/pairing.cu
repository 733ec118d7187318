// The batched BLS product check e(-g1, sig)·e(pk, H(m)) == 1 on Hopper:
// two kernels, one warp per check (one check = two Miller pairs).
//
// K1 miller_loop_kernel replaces the JAX package's Miller-loop Pallas
// kernels, ops/pallas_pairing.py:_miller_kernel and its grid twin
// _miller_grid_kernel. The TPU walked the 63 iterations as a sequential
// grid axis with the state in VMEM scratch; here the loop runs inside the
// warp, with the add step only on the set bits of |x| (the flag table in
// the constant buffer). Line formulas are those of _dbl_step, _add_step
// and _lines_product (pallas_pairing.py:100-172), written once below for
// the step kernel and once as K1's step tables (ops/pairing.py
// _sched_dbl_step ...), so the output f equals the JAX kernel's f, not
// only after the final exponentiation.
//
// K2 final_exp_verdict_kernel replaces, fused, the final-exponentiation
// Pallas kernels of pallas_pairing.py: _easy_kernel/_easy_grid_kernel,
// _pow_kernel/_pow_grid_kernel (five calls), _mul_frob1_kernel,
// _a4_kernel and _is_one_kernel (and their grid twins). The TPU split
// them because of Mosaic's VMEM and register limits; one warp runs the
// whole chain here. It writes the GT value (the CUBE of the canonical
// pairing, as final_exp_hard_bl and crypto.pairing.final_exponentiation
// (canonical=False) compute it) and the check's verdict.
//
// Bound: integer multiply-adds (see fp.cuh): K1 does 11,878 Fp products a
// check, K2 8,657; inputs and outputs are a few hundred bytes. Each check
// is one long chain, so the time is that chain's latency, and at the
// buckets the paths launch (4, 128, 512) the card is far from full. So
// K1 and K2 run a check on a warp (csrc/f12_group.cuh): each Fp value on
// a half-group of four threads (fp_group.cuh), the check's Fp2 values in
// shared-memory slots, and at each step the eight half-groups run eight
// independent Fp2 operations of the check. The steps are tables
// (ops/pairing.py compiled_programs): one Miller iteration without and one
// with the add step (f², both pairs' doubling steps and lines, and their
// products side by side), the easy part around the Fermat inversion, one
// cyclotomic squaring, one product by the base, and the glue between the
// five exponentiations of the Hayashida chain; the loops over the bits of
// |x|, |x-1| and p-2 (the same on every thread) stay here. F12_CHECKS
// checks a block; a warp whose check lies past n returns as a whole.
//
// miller_step_kernel replaces the prototype tools/proto_miller_grid.py:
// _miller_grid_kernel, the Miller loop as a grid of N_MILLER steps with f
// and T carried in VMEM scratch, which tested whether the loop body was too
// large for the TPU compiler's register allocation. Here one launch runs
// one iteration (miller_iteration below, on fp.cuh's one-thread tower: the
// design K1 had before it moved to a warp a check) for every lane, f and T
// live in device memory between launches, the host passes each step's add
// flag, and the last step writes conj(f): the output equals K1's word for
// word, and ptxas's registers and spills of the one-iteration body stand
// for the one-thread tower. Its state (f and T, 432 words a lane) is read
// and written once a step, a few hundred bytes against some 190 Fp
// products. One thread a lane, blocks of 32 lanes.
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

#if defined(__CUDACC__) || defined(GG_WARP_EMULATION)
// Checks a block: two warps, 2 × 19,712 bytes of slots
#define F12_CHECKS 2
#include "f12_group.cuh"

// The programs of the step tables (ops/pairing.py PROGRAMS, same order)
enum : uint32_t {
  F12P_K1_INIT = 0, F12P_K1_DBL, F12P_K1_DBL_ADD, F12P_K1_FIN,
  F12P_K2_EASY_HEAD, F12P_K2_RECIP_ONE, F12P_K2_RECIP_SQR,
  F12P_K2_RECIP_MUL, F12P_K2_EASY_TAIL, F12P_K2_CYC_SQR, F12P_K2_CYC_MUL,
  F12P_K2_NEXT, F12P_K2_KEEP, F12P_K2_FROB1, F12P_K2_CLOSE, F12P_COUNT
};

// The rows of an Fp12 at SRC (F12_WORDS, the (2, 3, 2, 12) layout) into
// the six slots from S, row r by half-group r
FG_INL void k12_load_rows(uint32_t s, const uint32_t* src) {
  const uint32_t r = fo_hg();
  if (r < 6) fo_put(s + r, src + r * 2 * NW, src + r * 2 * NW + NW);
}

// The six slots from S to the rows at DST, row r by half-group r
FG_INL void k12_store_rows(uint32_t* dst, uint32_t s) {
  const uint32_t r = fo_hg();
  if (r < 6) fo_get(dst + r * 2 * NW, s + r);
}

// K1 for one check on the calling threads: xp, yp (2, 12), q (2, 2, 2,
// 12) -> f (F12_WORDS). Inputs 0-3 are xp0, xp1, yp0, yp1 as (x, 0),
// 4-7 the four Fp2 coordinates of q, input i loaded by half-group i;
// k1_init sets T = (Q, 1) and f = 1.
FG_INL void k1_check(const uint32_t* xp, const uint32_t* yp,
                     const uint32_t* q, uint32_t* f) {
  fo_init();
  fo_put_consts();
  const uint32_t i = fo_hg();
  if (i < 4)
    fo_put(FS.named[NM_P] + i, (i < 2 ? xp : yp) + (i % 2) * NW, nullptr);
  else
    fo_put(FS.named[NM_Q] + i - 4, q + (i - 4) * 2 * NW,
           q + (i - 4) * 2 * NW + NW);
  __syncwarp();
  fo_run(F12P_K1_INIT);
#pragma unroll 1
  for (uint32_t i = 0; i < C.n_miller; ++i)
    fo_run(C.miller_flags[i] ? F12P_K1_DBL_ADD : F12P_K1_DBL);
  fo_run(F12P_K1_FIN);  // conj(f): x < 0
  k12_store_rows(f, FS.named[NM_OUT]);
}

// m^(-|e|) into the acc slots, MSB first, from base = conj(m) and acc = 1
// (set by the program before): a cyclotomic squaring every bit, a product
// by the base on the set ones
FG_INL void k2_pow(const uint32_t* bits, uint32_t nbits) {
#pragma unroll 1
  for (uint32_t i = 0; i < nbits; ++i) {
    fo_run(F12P_K2_CYC_SQR);
    if (bits[i]) fo_run(F12P_K2_CYC_MUL);
  }
}

// K2 for one check on the calling threads: f (F12_WORDS) -> gt
// (F12_WORDS) and the verdict. The easy part (f12_inv's
// Fermat inversion of one Fp norm on half-group 0, over the bits of
// p-2), then the Hayashida chain:
// a1 = m^-|x-1|, a2 = a1^-|x-1|, a3 = a2^-|x|·frob(a2, 1), a4 =
// (a3^-|x|)^-|x|·frob(a3, 2)·conj(a3), gt = a4·(m·cyc_sqr(m)).
FG_INL uint32_t k2_check(const uint32_t* f, uint32_t* gt) {
  fo_init();
  fo_put_consts();
  const uint32_t k = fo_hg();
  if (k < 6) {
    fo_put(FS.named[NM_GAMMA1] + k, C.gamma1[k].c0.w, C.gamma1[k].c1.w);
    fo_put(FS.named[NM_GAMMA2] + k, C.gamma2[k].c0.w, C.gamma2[k].c1.w);
  }
  k12_load_rows(FS.named[NM_F], f);
  __syncwarp();
  fo_run(F12P_K2_EASY_HEAD);
  fo_run(F12P_K2_RECIP_ONE);
#pragma unroll 1
  for (uint32_t i = 0; i < C.n_pm2; ++i) {
    fo_run(F12P_K2_RECIP_SQR);
    if (C.pm2[i]) fo_run(F12P_K2_RECIP_MUL);
  }
  fo_run(F12P_K2_EASY_TAIL);
  k2_pow(C.bits_xm1, C.n_xm1);
  fo_run(F12P_K2_NEXT);
  k2_pow(C.bits_xm1, C.n_xm1);
  fo_run(F12P_K2_KEEP);
  k2_pow(C.bits_x, C.n_x);
  fo_run(F12P_K2_FROB1);
  k2_pow(C.bits_x, C.n_x);
  fo_run(F12P_K2_NEXT);
  k2_pow(C.bits_x, C.n_x);
  fo_run(F12P_K2_CLOSE);
  const uint32_t one = fo_is_one(FS.named[NM_OUT]);
  k12_store_rows(gt, FS.named[NM_OUT]);
  return one;
}
#endif  // __CUDACC__ || GG_WARP_EMULATION

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// The calling warp's check; a warp whose check lies past n returns as
// a whole
__device__ __forceinline__ int f12_check() {
  return blockIdx.x * F12_CHECKS + (int)(threadIdx.x / 32u);
}

__global__ void __launch_bounds__(F12_BLOCK)
miller_loop_kernel(const uint32_t* __restrict__ xp,
                   const uint32_t* __restrict__ yp,
                   const uint32_t* __restrict__ q, uint32_t* __restrict__ f,
                   int n) {
  const int c = f12_check();
  if (c >= n) return;
  k1_check(xp + (size_t)c * NPAIRS * NW, yp + (size_t)c * NPAIRS * NW,
           q + (size_t)c * NPAIRS * 4 * NW, f + (size_t)c * F12_WORDS);
}

__global__ void __launch_bounds__(F12_BLOCK)
final_exp_verdict_kernel(const uint32_t* __restrict__ f,
                         uint32_t* __restrict__ gt, int32_t* __restrict__ ok,
                         int n) {
  const int c = f12_check();
  if (c >= n) return;
  const uint32_t one =
      k2_check(f + (size_t)c * F12_WORDS, gt + (size_t)c * F12_WORDS);
  if (threadIdx.x % 32u == 0) ok[c] = one ? 1 : 0;
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

// K1's and K2's constant buffer (ops/pairing.py pairing_consts): struct
// Consts, then the step tables, struct FoSched
static cudaError_t load_pairing_consts(const void* consts, int n_words,
                                       cudaStream_t s) {
  if (n_words * sizeof(uint32_t) != sizeof(Consts) + sizeof(FoSched))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(C, consts, sizeof(Consts), 0,
                                          cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return e;
  return cudaMemcpyToSymbolAsync(FS, (const char*)consts + sizeof(Consts),
                                 sizeof(FoSched), 0, cudaMemcpyDeviceToDevice,
                                 s);
}

static dim3 f12_grid(int n) {
  return dim3((n + F12_CHECKS - 1) / F12_CHECKS);
}

extern "C" int miller_loop_launch(const void* consts, int n_words,
                                  const void* xp, const void* yp,
                                  const void* q, void* f, int n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = load_pairing_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  miller_loop_kernel<<<f12_grid(n), F12_BLOCK, 0, s>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)q,
      (uint32_t*)f, n);
  return (int)cudaGetLastError();
}

extern "C" int final_exp_verdict_launch(const void* consts, int n_words,
                                        const void* f, void* gt, void* ok,
                                        int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = load_pairing_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  final_exp_verdict_kernel<<<f12_grid(n), F12_BLOCK, 0, s>>>(
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
