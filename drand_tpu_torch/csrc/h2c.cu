// The wire path's device prep on Hopper: hash-to-G2 of message u-values
// and decompression of compressed G2 signatures, one thread per lane.
//
// K5 hash_to_g2_kernel replaces, fused, four Pallas kernels of the JAX
// package's ops/pallas_wire.py: _map_kernel (run twice: simplified SWU
// onto E' and the 3-isogeny onto E2), _ptadd_affine_kernel (map(u0) +
// map(u1)), _mulx_kernel (run twice: the [x]-chains of Budroni-Pintore
// cofactor clearing) and _clear_glue_kernel ([x^2-x-1]P + psi([x-1]P) +
// psi^2([2]P), then to affine). The TPU split the chain because of
// Mosaic's VMEM and register limits; one thread runs all of it here.
//
// K6 decompress_g2_kernel replaces pallas_wire.py:_sig_kernel: y =
// sqrt(x^3 + 4(1+u)) by the (p^2+7)/16 candidate and the four
// 4th-root-of-unity corrections, the zcash sign rule, and Scott's
// subgroup check psi(Q) == [x]Q (ops/bl_curve.subgroup_check).
//
// Bound: integer multiply-adds. K5 does up to 13,100 Fp products per lane
// (four square roots of ~2,100 each — the second root of a map only where
// the first candidate is not a square — two inversions of ~570, two
// [x]-chains of ~1,230) and K6 up to 3,400 (one square root, one
// [x]-chain, skipped where x is not on the curve);
// inputs and outputs are under 200 bytes per lane. Each lane is one long
// dependent chain, so the time is that chain's latency: blocks of 32
// lanes spread a bucket of 512 over 16 SMs. Every exponent bit (the
// square root's, p-2's, |x|'s) is the same on every lane, so the loops
// branch on them and a warp never diverges there; lanes diverge only on
// the SSWU branches (tv == 0, gx1 not a square), the sign flips and the
// rejected lanes of K6. Every function is out of line, as in fp.cuh.
//
// Outputs are affine, hence unique: the kernels agree word for word with
// their plain versions (ops/h2c.py hash_to_g2_plain, decompress_plain)
// whatever the formula order. A lane hashing to infinity writes zeros
// and inf = 1; a lane K6 rejects writes zeros and ok = 0.
//
// Constants: the shared buffer of fp.cuh (p, R, the bits of p-2 and |x|)
// and this file's own, struct H2cConsts, built by ops/h2c.py:h2c_consts()
// from the port's host crypto and copied into constant memory at launch.
//
// Layouts (int32 words of canonical Montgomery values):
//   u     (n, 2, 2, 12)  two Fp2 u-values per message, c0 / c1
//   x     (n, 2, 12)     signature x-coordinate, c0 / c1
//   sign  (n,)           the signature's sort flag
//   xy    (n, 2, 2, 12)  affine x / y, c0 / c1
//   inf   (n,)           K5: 1 iff the hashed point is infinity
//   ok    (n,)           K6: 1 iff on the curve and in G2
#include "curve.cuh"

#define H2C_BLOCK 32
#define SQRT_BITS_WIDTH 768

// Layout of this kernel's constant buffer (uint32 words), built by
// ops/h2c.py:h2c_consts() in this order. Fp2 values are Montgomery;
// half_p is the plain integer (p-1)/2.
struct H2cConsts {
  uint32_t n_sqrt;          // bits of (p^2+7)/16 (758)
  uint32_t pad[3];
  Fp half_p;
  Fp2 sswu_a, sswu_b, sswu_z;   // E': y^2 = x^3 + A'x + B', Z
  Fp2 sswu_mba, sswu_bza;       // -B'/A', B'/(Z·A')
  Fp2 iso_x0, iso_vsum, iso_usum, iso_c2, iso_c3;  // the 3-isogeny
  Fp2 b_g2;                     // 4(1+u)
  Fp2 roots4[4];                // 4th roots of unity: 1, u, sqrt(u), sqrt(-u)
  Fp2 psi_cx, psi_cy, psi2_cx, psi2_cy;
  uint32_t sqrt_bits[SQRT_BITS_WIDTH];  // (p^2+7)/16, MSB first
};

FP_CONST H2cConsts HC;

typedef Jac<Fp2> G2J;

FP_INL bool f2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// a > b as plain integers
FP_INL bool fp_gt(const Fp& a, const Fp& b) {
  for (int i = NW - 1; i >= 0; --i)
    if (a.w[i] != b.w[i]) return a.w[i] > b.w[i];
  return false;
}

// Montgomery -> canonical integer: a·1·R^-1
FP_INL void fp_from_mont(Fp& r, const Fp& a) {
  Fp one;
  fp_zero(one);
  one.w[0] = 1u;
  fp_mul(r, a, one);
}

// ---------------------------------------------------------------------------
// square root, sign rules
// ---------------------------------------------------------------------------

// a^((p^2+7)/16) by 4-bit fixed windows, MSB first: a table a^1..a^15
// (tab[k] = tab[k-q]·tab[q], q the largest power of two below k — the
// order the plain version stacks it in), then per window four squarings
// and, for a nonzero digit, one product. The digits are the same on every
// lane; the table lives in local memory.
FP_FN void f2_pow_sqrt(Fp2& r, const Fp2& a) {
  Fp2 tab[16];
  tab[1] = a;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    int q = 1;
    while (2 * q < k) q *= 2;
    f2_mul(tab[k], tab[k - q], tab[q]);
  }
  const int n = (int)HC.n_sqrt;
  const int lead = n % 4 == 0 ? 4 : n % 4;  // bits of the top window
  uint32_t d = 0;
  for (int i = 0; i < lead; ++i) d = 2 * d + HC.sqrt_bits[i];
  Fp2 acc = tab[d];
#pragma unroll 1
  for (int i = lead; i < n; i += 4) {
    d = 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      f2_sqr(acc, acc);
      d = 2 * d + HC.sqrt_bits[i + j];
    }
    if (d) f2_mul(acc, acc, tab[d]);
  }
  r = acc;
}

// 1 iff a is a square; r = the candidate times the first 4th root of unity
// whose square is a (the candidate itself where none is)
FP_FN uint32_t sqrt_f2(Fp2& r, const Fp2& a) {
  const Fp2 av = a;
  Fp2 cand, t, s, root, out;
  f2_pow_sqrt(cand, av);
  uint32_t found = 0u;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    root = HC.roots4[i];
    f2_mul(t, cand, root);
    f2_sqr(s, t);
    const uint32_t hit = f2_eq(s, av) ? 1u : 0u;
    if (i == 0 || (hit && !found)) out = t;
    found |= hit;
  }
  r = out;
  return found;
}

// RFC 9380 sgn0 of an Fp2 value
FP_FN uint32_t sgn0_f2(const Fp2& a) {
  Fp c0, c1;
  fp_from_mont(c0, a.c0);
  fp_from_mont(c1, a.c1);
  const uint32_t zero0 = fe_is_zero(c0) ? 1u : 0u;
  return (c0.w[0] & 1u) | (zero0 & c1.w[0] & 1u);
}

// zcash sign rule: y > -y lexicographically (c1 first, then c0)
FP_FN uint32_t lex_largest_f2(const Fp2& y) {
  Fp c0, c1;
  fp_from_mont(c0, y.c0);
  fp_from_mont(c1, y.c1);
  const Fp half = HC.half_p;
  if (!fe_is_zero(c1)) return fp_gt(c1, half) ? 1u : 0u;
  return fp_gt(c0, half) ? 1u : 0u;
}

// ---------------------------------------------------------------------------
// simplified SWU onto E' and the 3-isogeny onto E2 (bl_h2c.map_to_curve)
// ---------------------------------------------------------------------------

FP_FN void g_prime(Fp2& r, const Fp2& x) {
  const Fp2 a = HC.sswu_a, b = HC.sswu_b;
  Fp2 t, ax;
  f2_sqr(t, x);
  f2_mul(t, t, x);
  f2_mul(ax, a, x);
  f2_add(t, t, ax);
  f2_add(r, t, b);
}

// u -> a Jacobian point on E2 before clearing: SWU onto E' (affine), then
// the 3-isogeny with Z = d = x - x0, which needs no inversion:
//   X = c2·(x·d^2 + V·d + U),  Y = c3·y·(d^3 - V·d - 2U)
// (affine X/Z^2 = c2·(x + V/d + U/d^2), Y/Z^3 = c3·y·(1 - V/d^2 - 2U/d^3));
// d = 0, a kernel point of the isogeny, maps to infinity
FP_FN void map_to_curve(G2J& out, const Fp2& u) {
  const Fp2 z = HC.sswu_z;
  Fp2 zu2, tv, x1, x, y, t, one;
  fe_one(one);
  f2_sqr(t, u);
  f2_mul(zu2, z, t);
  f2_sqr(tv, zu2);
  f2_add(tv, tv, zu2);
  if (fe_is_zero(tv)) {
    x1 = HC.sswu_bza;
  } else {
    const Fp2 mba = HC.sswu_mba;
    f2_inv(t, tv);
    f2_add(t, one, t);
    f2_mul(x1, mba, t);
  }
  g_prime(t, x1);
  if (sqrt_f2(y, t)) {
    x = x1;
  } else {
    f2_mul(x, zu2, x1);
    g_prime(t, x);
    sqrt_f2(y, t);
  }
  if (sgn0_f2(u) != sgn0_f2(y)) f2_neg(y, y);
  const Fp2 x0 = HC.iso_x0, vs = HC.iso_vsum, us = HC.iso_usum;
  const Fp2 c2 = HC.iso_c2, c3 = HC.iso_c3;
  Fp2 d, d2, a, b;
  f2_sub(d, x, x0);
  f2_sqr(d2, d);
  f2_mul(a, x, d2);
  f2_mul(b, vs, d);
  f2_add(a, a, b);
  f2_add(a, a, us);
  f2_mul(out.x, c2, a);
  f2_mul(a, d2, d);
  f2_add(t, us, us);
  f2_add(t, b, t);
  f2_sub(a, a, t);
  f2_mul(a, y, a);
  f2_mul(out.y, c3, a);
  out.z = d;
  out.inf = fe_is_zero(d) ? 1u : 0u;
}

// ---------------------------------------------------------------------------
// G2 maps (ops/bl_curve.py): psi, [x], Scott's check, Budroni-Pintore
// ---------------------------------------------------------------------------

FP_INL void pt_neg(G2J& r, const G2J& p) {
  r = p;
  f2_neg(r.y, p.y);
}

// psi(X, Y, Z) = (cx·conj(X), cy·conj(Y), conj(Z))
FP_FN void psi(G2J& r, const G2J& p) {
  const Fp2 cx = HC.psi_cx, cy = HC.psi_cy;
  Fp2 t;
  f2_conj(t, p.x);
  f2_mul(r.x, t, cx);
  f2_conj(t, p.y);
  f2_mul(r.y, t, cy);
  f2_conj(r.z, p.z);
  r.inf = p.inf;
}

FP_FN void psi2(G2J& r, const G2J& p) {
  const Fp2 cx = HC.psi2_cx, cy = HC.psi2_cy;
  f2_mul(r.x, p.x, cx);
  f2_mul(r.y, p.y, cy);
  r.z = p.z;
  r.inf = p.inf;
}

// [x]P, x < 0: [|x|]P MSB first from P (the leading bit) — 63 doublings
// and 5 additions, the same on every lane — then negated
FP_FN void mul_x(G2J& r, const G2J& p) {
  G2J acc = p;
  for (uint32_t i = 1; i < C.n_x; ++i) {
    pt_dbl(acc, acc);
    if (C.bits_x[i]) pt_add(acc, acc, p);
  }
  pt_neg(r, acc);
}

// psi(Q) == [x]Q by Jacobian cross-multiplication; infinity is a member
FP_FN uint32_t subgroup_check(const G2J& q) {
  if (q.inf) return 1u;
  G2J lhs, rhs;
  psi(lhs, q);
  mul_x(rhs, q);
  if (lhs.inf || rhs.inf) return (lhs.inf && rhs.inf) ? 1u : 0u;
  Fp2 z1s, z2s, a, b;
  f2_sqr(z1s, lhs.z);
  f2_sqr(z2s, rhs.z);
  f2_mul(a, lhs.x, z2s);
  f2_mul(b, rhs.x, z1s);
  if (!f2_eq(a, b)) return 0u;
  f2_mul(z1s, z1s, lhs.z);
  f2_mul(z2s, z2s, rhs.z);
  f2_mul(a, lhs.y, z2s);
  f2_mul(b, rhs.y, z1s);
  return f2_eq(a, b) ? 1u : 0u;
}

// [h_eff]P = [x^2-x-1]P + psi([x-1]P) + psi^2([2]P)
FP_FN void clear_cofactor(G2J& r, const G2J& p) {
  G2J t1, t2, np, a, b;
  mul_x(t1, p);
  mul_x(t2, t1);
  pt_neg(np, p);
  pt_neg(a, t1);
  pt_add(a, t2, a);
  pt_add(a, a, np);
  pt_add(b, t1, np);
  psi(b, b);
  pt_add(a, a, b);
  pt_dbl(b, p);
  psi2(b, b);
  pt_add(r, a, b);
}

// ---------------------------------------------------------------------------
// one lane of each kernel (host-callable for checks)
// ---------------------------------------------------------------------------

FP_FN void hash_lane(uint32_t* xy, uint32_t* inf, const uint32_t* u) {
  Fp2 u0, u1;
  load_f2(u0, u);
  load_f2(u1, u + 2 * NW);
  G2J p0, p1, q;
  map_to_curve(p0, u0);
  map_to_curve(p1, u1);
  pt_add(q, p0, p1);
  clear_cofactor(q, q);
  Fp2 ax, ay;
  if (q.inf) {
    f2_zero(ax);
    f2_zero(ay);
  } else {
    pt_to_affine(ax, ay, q);
  }
  store_f2(xy, ax);
  store_f2(xy + 2 * NW, ay);
  *inf = q.inf;
}

FP_FN void decompress_lane(uint32_t* xy, uint32_t* ok_out, const uint32_t* xw,
                           int32_t sign) {
  const Fp2 b = HC.b_g2;
  Fp2 x, y, t;
  load_f2(x, xw);
  f2_sqr(t, x);
  f2_mul(t, t, x);
  f2_add(t, t, b);
  uint32_t ok = sqrt_f2(y, t);
  if (ok) {
    if (lex_largest_f2(y) != (sign != 0 ? 1u : 0u)) f2_neg(y, y);
    G2J q;
    q.x = x;
    q.y = y;
    fe_one(q.z);
    q.inf = 0u;
    ok = subgroup_check(q);
  }
  if (!ok) {
    f2_zero(x);
    f2_zero(y);
  }
  store_f2(xy, x);
  store_f2(xy + 2 * NW, y);
  *ok_out = ok;
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(H2C_BLOCK)
hash_to_g2_kernel(const uint32_t* __restrict__ u, uint32_t* __restrict__ xy,
                  uint32_t* __restrict__ inf, int n) {
  const int lane = blockIdx.x * H2C_BLOCK + threadIdx.x;
  if (lane >= n) return;
  hash_lane(xy + (size_t)lane * 4 * NW, inf + lane,
            u + (size_t)lane * 4 * NW);
}

__global__ void __launch_bounds__(H2C_BLOCK)
decompress_g2_kernel(const uint32_t* __restrict__ x,
                     const int32_t* __restrict__ sign,
                     uint32_t* __restrict__ xy, uint32_t* __restrict__ ok,
                     int n) {
  const int lane = blockIdx.x * H2C_BLOCK + threadIdx.x;
  if (lane >= n) return;
  decompress_lane(xy + (size_t)lane * 4 * NW, ok + lane,
                  x + (size_t)lane * 2 * NW, sign[lane]);
}

static int h2c_grid(int n) { return (n + H2C_BLOCK - 1) / H2C_BLOCK; }

// Copy both constant buffers into this library's constant memory.
static cudaError_t load_h2c_consts(const void* consts, int n_words,
                                   const void* hconsts, int n_hwords,
                                   cudaStream_t s) {
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return e;
  if (n_hwords * sizeof(uint32_t) != sizeof(H2cConsts))
    return cudaErrorInvalidValue;
  return cudaMemcpyToSymbolAsync(HC, hconsts, sizeof(H2cConsts), 0,
                                 cudaMemcpyDeviceToDevice, s);
}

extern "C" int hash_to_g2_launch(const void* consts, int n_words,
                                 const void* hconsts, int n_hwords,
                                 const void* u, void* xy, void* inf, int n,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = load_h2c_consts(consts, n_words, hconsts, n_hwords, s);
  if (e != cudaSuccess) return (int)e;
  hash_to_g2_kernel<<<h2c_grid(n), H2C_BLOCK, 0, s>>>(
      (const uint32_t*)u, (uint32_t*)xy, (uint32_t*)inf, n);
  return (int)cudaGetLastError();
}

extern "C" int decompress_g2_launch(const void* consts, int n_words,
                                    const void* hconsts, int n_hwords,
                                    const void* x, const void* sign, void* xy,
                                    void* ok, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = load_h2c_consts(consts, n_words, hconsts, n_hwords, s);
  if (e != cudaSuccess) return (int)e;
  decompress_g2_kernel<<<h2c_grid(n), H2C_BLOCK, 0, s>>>(
      (const uint32_t*)x, (const int32_t*)sign, (uint32_t*)xy,
      (uint32_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
