// BLS12-381 field tower for one thread per lane: Fp (12 x 32-bit words,
// Montgomery, R = 2^384), Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3-xi) with
// xi = 1+u, Fp12 = Fp6[w]/(w^2-v).
//
// Replaces the field tower of the JAX package's ops/bl.py (Fp/Fp2/Fp6/Fp12
// on 32 lazily reduced 12-bit limbs, batch on the TPU's vector lanes). Here
// a value is held in full 32-bit words and every function returns it fully
// reduced below p (CIOS Montgomery product, conditional subtraction after
// each add/sub), so no lazy-carry bound has to be proven. The formulas are
// those of ops/field.py (the plain PyTorch version): Karatsuba f2/f6/f12
// products, complex f12 squaring, Fermat inversion.
//
// What bounds it on an H100: integer multiply-adds. One Fp product is 288
// 32x32->64 multiply-adds (144 for the product, 144 for the reduction);
// there is no memory traffic to speak of. This tower keeps one lane's
// state in one thread and every tower function out of line
// (__noinline__), which keeps the kernels small enough to compile in
// seconds; its cost is register spills and call overhead, measured in
// PERF.md. The Horner and the Miller step probe run on it. K1 and K2
// (csrc/f12_group.cuh), K5, K6 and the MSM (csrc/g2_group.cuh) run on
// fp_group.cuh instead: a group of threads per check, each Fp value's
// words spread over four threads; the Horner waits for the same redesign
// (ROADMAP, queue 2).
//
// Constants (p, -p^-1 mod 2^32, R mod p, the Frobenius gamma rows and the
// exponent bit tables) are NOT written here: ops/pairing.py computes them
// from the port's host field code and passes them as a device buffer,
// which the launch copies into constant memory (struct Consts below; the
// launch checks the buffer size against it).
//
// The header also compiles as plain C++ (no __CUDACC__), so the same
// arithmetic can be checked on a host compiler.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define FP_INL __device__ __forceinline__
#define FP_FN __device__ __noinline__
#define FP_CONST __constant__
#else
#define FP_INL static inline
#define FP_FN static
#define FP_CONST static
#endif

#define NW 12

struct Fp { uint32_t w[NW]; };
struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c[3]; };
struct Fp12 { Fp6 c[2]; };  // c[0] + c[1]·w

// Layout of the constant buffer (uint32 words), built by
// ops/pairing.py:kernel_consts() in this order.
struct Consts {
  uint32_t n_miller;        // doublings of the Miller loop (63)
  uint32_t n_x;             // bits of |x| (64)
  uint32_t n_xm1;           // bits of |x-1| (64)
  uint32_t n_pm2;           // bits of p-2 (381)
  uint32_t n0;              // -p^-1 mod 2^32
  uint32_t pad[3];
  Fp p;
  Fp one;                   // R mod p
  Fp2 gamma1[6];            // Frobenius coefficients, w-basis, Montgomery
  Fp2 gamma2[6];
  uint32_t miller_flags[64];  // add step after doubling i (bits of |x| after the MSB)
  uint32_t bits_x[64];      // |x|, MSB first
  uint32_t bits_xm1[64];    // |x-1|, MSB first
  uint32_t pm2[384];        // p-2, MSB first
};

FP_CONST Consts C;

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// Copy the constant buffer (built by ops/pairing.py:kernel_consts) into
// this library's constant memory, on the launch's stream.
static cudaError_t load_consts(const void* consts, int n_words,
                               cudaStream_t stream) {
  if (n_words * sizeof(uint32_t) != sizeof(Consts))
    return cudaErrorInvalidValue;
  return cudaMemcpyToSymbolAsync(C, consts, sizeof(Consts), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
#endif

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

FP_INL void fp_copy(Fp& r, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = a.w[i];
}

FP_INL void fp_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0u;
}

// r = s - p if s >= p, else s (s < 2p; s has no carry word since 2p < 2^384)
FP_INL void fp_reduce_once(Fp& r, const uint32_t* s) {
  uint32_t d[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t t = (int64_t)s[i] - (int64_t)C.p.w[i] + br;
    d[i] = (uint32_t)t;
    br = t >> 32;  // 0 or -1
  }
  const bool lt = br < 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = lt ? s[i] : d[i];
}

FP_INL void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, s);
}

FP_INL void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t t = (int64_t)a.w[i] - (int64_t)b.w[i] + br;
    d[i] = (uint32_t)t;
    br = t >> 32;
  }
  // a - b < 0: add p back (the carry out of the top word is the 2^384 wrap)
  const uint32_t mask = br < 0 ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)d[i] + (C.p.w[i] & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

FP_INL void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// Montgomery product a·b·2^-384 mod p, coarsely integrated operand scanning.
FP_FN void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a.w[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * C.n0;
    c = (uint64_t)m * C.p.w[0] + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * C.p.w[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p < 2^382, so t[NW] == 0
  fp_reduce_once(r, t);
}

// a^(p-2) = a^-1 (Fermat), MSB-first square-and-multiply
FP_FN void fp_inv(Fp& r, const Fp& a) {
  Fp acc;
  fp_copy(acc, C.one);
  for (uint32_t i = 0; i < C.n_pm2; ++i) {
    fp_mul(acc, acc, acc);
    if (C.pm2[i]) fp_mul(acc, acc, a);
  }
  fp_copy(r, acc);
}

// ---------------------------------------------------------------------------
// Fp2
// ---------------------------------------------------------------------------

FP_INL void f2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

FP_INL void f2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

FP_INL void f2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

FP_INL void f2_dbl(Fp2& r, const Fp2& a) { f2_add(r, a, a); }

FP_INL void f2_zero(Fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

// xi·a = (a0 - a1) + (a0 + a1)·u
FP_INL void f2_mul_by_xi(Fp2& r, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  fp_copy(r.c0, t0);
  fp_copy(r.c1, t1);
}

// Karatsuba: three Fp products
FP_FN void f2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp v0, v1, v2, sa, sb;
  fp_mul(v0, a.c0, b.c0);
  fp_mul(v1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(v2, sa, sb);
  fp_sub(r.c0, v0, v1);
  fp_add(sa, v0, v1);
  fp_sub(r.c1, v2, sa);
}

// (a0 + a1)(a0 - a1) + 2·a0·a1·u
FP_FN void f2_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, v0, v1;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(v0, s, d);
  fp_mul(v1, a.c0, a.c1);
  fp_copy(r.c0, v0);
  fp_add(r.c1, v1, v1);
}

FP_INL void f2_mul_fp(Fp2& r, const Fp2& a, const Fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

FP_FN void f2_inv(Fp2& r, const Fp2& a) {
  Fp n0, n1, t;
  fp_mul(n0, a.c0, a.c0);
  fp_mul(n1, a.c1, a.c1);
  fp_add(n0, n0, n1);
  fp_inv(t, n0);
  fp_mul(n0, a.c0, t);
  fp_mul(n1, a.c1, t);
  fp_copy(r.c0, n0);
  fp_neg(r.c1, n1);
}

// ---------------------------------------------------------------------------
// Fp6
// ---------------------------------------------------------------------------

FP_INL void f6_add(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_add(r.c[i], a.c[i], b.c[i]);
}

FP_INL void f6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_sub(r.c[i], a.c[i], b.c[i]);
}

FP_INL void f6_neg(Fp6& r, const Fp6& a) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_neg(r.c[i], a.c[i]);
}

// v·a = xi·a2 + a0·v + a1·v^2
FP_INL void f6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  f2_mul_by_xi(t, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// Karatsuba over Fp2: six Fp2 products
FP_FN void f6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 v0, v1, v2, m12, m01, m02, sa, sb;
  f2_mul(v0, a.c[0], b.c[0]);
  f2_mul(v1, a.c[1], b.c[1]);
  f2_mul(v2, a.c[2], b.c[2]);
  f2_add(sa, a.c[1], a.c[2]);
  f2_add(sb, b.c[1], b.c[2]);
  f2_mul(m12, sa, sb);
  f2_add(sa, a.c[0], a.c[1]);
  f2_add(sb, b.c[0], b.c[1]);
  f2_mul(m01, sa, sb);
  f2_add(sa, a.c[0], a.c[2]);
  f2_add(sb, b.c[0], b.c[2]);
  f2_mul(m02, sa, sb);
  // c0 = v0 + xi·(m12 - v1 - v2)
  f2_add(sa, v1, v2);
  f2_sub(sa, m12, sa);
  f2_mul_by_xi(sa, sa);
  f2_add(r.c[0], v0, sa);
  // c1 = m01 - v0 - v1 + xi·v2
  f2_add(sa, v0, v1);
  f2_sub(sa, m01, sa);
  f2_mul_by_xi(sb, v2);
  f2_add(r.c[1], sa, sb);
  // c2 = m02 - v0 - v2 + v1
  f2_add(sa, v0, v2);
  f2_sub(sa, m02, sa);
  f2_add(r.c[2], sa, v1);
}

// ---------------------------------------------------------------------------
// Fp12
// ---------------------------------------------------------------------------

FP_INL void f12_one(Fp12& r) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 3; ++i) f2_zero(r.c[h].c[i]);
  fp_copy(r.c[0].c[0].c0, C.one);
}

FP_INL void f12_conj(Fp12& r, const Fp12& a) {
  r.c[0] = a.c[0];
  f6_neg(r.c[1], a.c[1]);
}

// Karatsuba over Fp6: three Fp6 products
FP_FN void f12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 v0, v1, v2, sa, sb;
  f6_mul(v0, a.c[0], b.c[0]);
  f6_mul(v1, a.c[1], b.c[1]);
  f6_add(sa, a.c[0], a.c[1]);
  f6_add(sb, b.c[0], b.c[1]);
  f6_mul(v2, sa, sb);
  // c0 = v0 + v·v1 ; c1 = v2 - v0 - v1
  f6_mul_by_v(sa, v1);
  f6_add(sb, v0, v1);
  f6_add(r.c[0], v0, sa);
  f6_sub(r.c[1], v2, sb);
}

// c0 = (a0+a1)(a0+v·a1) - v0 - v·v0, c1 = 2·v0 with v0 = a0·a1
FP_FN void f12_sqr(Fp12& r, const Fp12& a) {
  Fp6 v0, w, s, t;
  f6_mul(v0, a.c[0], a.c[1]);
  f6_add(s, a.c[0], a.c[1]);
  f6_mul_by_v(t, a.c[1]);
  f6_add(t, a.c[0], t);
  f6_mul(w, s, t);
  f6_mul_by_v(t, v0);
  f6_add(t, v0, t);
  f6_sub(r.c[0], w, t);
  f6_add(r.c[1], v0, v0);
}

// w-basis access: coefficient of w^k is c[k % 2].c[k / 2]
#define W_AT(a, k) ((a).c[(k) % 2].c[(k) / 2])
