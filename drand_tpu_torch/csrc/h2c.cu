// The wire path's device prep on Hopper: hash-to-G2 of message u-values
// (K5, a group of eight threads per check) and decompression of
// compressed G2 signatures (K6, one thread per lane).
//
// K5 hash_to_g2_kernel replaces, fused, four Pallas kernels of the JAX
// package's ops/pallas_wire.py: _map_kernel (run twice: simplified SWU
// onto E' and the 3-isogeny onto E2), _ptadd_affine_kernel (map(u0) +
// map(u1)), _mulx_kernel (run twice: the [x]-chains of Budroni-Pintore
// cofactor clearing) and _clear_glue_kernel ([x^2-x-1]P + psi([x-1]P) +
// psi^2([2]P), then to affine). The TPU split the chain because of
// Mosaic's VMEM and register limits; one group of threads runs all of it
// here.
//
// K6 decompress_g2_kernel replaces pallas_wire.py:_sig_kernel: y =
// sqrt(x^3 + 4(1+u)) by the (p^2+7)/16 candidate and the four
// 4th-root-of-unity corrections, the zcash sign rule, and Scott's
// subgroup check psi(Q) == [x]Q (ops/bl_curve.subgroup_check).
//
// Bound: integer multiply-adds. K5 does up to 13,100 Fp products per check
// (four square roots of ~2,100 each — the second root of a map only where
// the first candidate is not a square — two inversions of ~570, two
// [x]-chains of ~1,230) and K6 up to 3,400 (one square root, one
// [x]-chain, skipped where x is not on the curve); inputs and outputs are
// under 200 bytes per check. Each check is one long dependent chain, so
// the time is that chain's latency, and the card is far from full.
//
// K6 runs one thread per lane on fp.cuh's tower, every function out of
// line; blocks of 32 lanes spread a bucket of 512 over 16 SMs. Every
// exponent bit (the square root's, p-2's, |x|'s) is the same on every
// lane, so the loops branch on them and a warp never diverges there;
// lanes diverge only on the sign flips and the rejected lanes.
//
// K5 runs each check on a group of K5_GROUP = 8 threads of one warp, on
// the cooperative arithmetic of fp_group.cuh: an Fp value's 12 words are
// spread over a half-group of four threads, which compute each product
// together. The two halves of a group run the two maps at once, map(u0)
// and map(u1); then each half takes the other's point by shuffles, and
// both compute the same sum, clearing and to-affine (the warp issues
// their instructions once), half 0 storing x and half 1 storing y. A
// bucket of 512 checks is 4,096 threads: one warp a block on 128 SMs.
//
// Every shuffle and ballot is over the whole warp, which stays converged
// at each of them (a mask per half-group made the hardware synchronise
// each mask group apart, several times slower); a group past n runs on
// the warp's first check and stores nothing instead of leaving. So a
// branch on a check's data (tv == 0, the sign flip, a point at infinity,
// H == 0 in an addition) runs where any check of the warp takes it, and
// each check then copies its own case's value, a copy holding no
// shuffle. Both SSWU candidates and their square roots are computed side
// by side, as hash_to_g2_plain computes them: eight maps to a warp need
// the second root in all but 1/256 of warps, so a warp took it anyway.
// The formulas, windows, exceptional cases and outputs are the
// one-thread kernel's.
//
// Between operations each thread keeps its own words of every live Fp2
// value in shared memory (a column of its own: no bank conflicts, no
// exchange through it), the square roots' window tables too; each Fp2
// operation is one small out-of-line function on slot numbers, straight
// line, with its operands in registers. Loops and branches stay in the
// driver between calls: ptxas cannot prove a warp converged after a
// branch inside a function, and then routes every shuffle after it
// through a divergence check and a synchronising slow path (several
// times slower per product).
//
// Outputs are affine, hence unique: the kernels agree word for word with
// their plain versions (ops/h2c.py hash_to_g2_plain, decompress_plain)
// whatever the formula order. A check hashing to infinity writes zeros
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
// G2 maps (ops/bl_curve.py): psi, [x], Scott's check
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

// ---------------------------------------------------------------------------
// K5: one check on a group of K5_GROUP threads (fp_group.cuh)
// ---------------------------------------------------------------------------

#if defined(__CUDACC__) || defined(H2C_WARP_EMULATION)
#include <stddef.h>

#include "fp_group.cuh"

#define K5_BLOCK 32              // one warp: four checks
#define K5_GROUP (2 * GT)        // threads per check: two half-groups

#if defined(__CUDACC__)
#define K5_FN __device__ __noinline__
#define K5_SHARED __shared__
#define K5_TID ((uint32_t)threadIdx.x)
#else  // a host emulation of one warp supplies h2c_emulated_tid()
#define K5_FN static
#define K5_SHARED static
#define K5_TID h2c_emulated_tid()
#endif

// Fp2 slots of a thread's shared-memory column. A point takes three
// consecutive slots (x, y, z); its infinity flag is a register of the
// driver below. The map's slots lie over the clearing's points, which are
// dead while the maps run; the square roots' window tables (a^1..a^15 in
// slots 1..15 and K5_TAB2 + 1..15) over the addition's temporaries and
// after every other slot.
enum : int {
  S_Z1Z1 = 0, S_Z2Z2, S_U1, S_U2, S_S1, S_S2, S_H, S_SD, S_TT, S_I, S_J,
  S_RR, S_V, S_X3, S_Y3, S_Z3,
  S_P0 = 16, S_P1 = 19,              // map(u0), map(u1); then the sum
  S_T1 = 22, S_T2 = 25, S_NP = 28, S_PA = 31, S_PB = 34, S_ACC = 37,
  S_DB = 40,                         // an addition's doubling case
  S_FN = 43, S_FI = 44,              // an inversion's norm and its inverse
  S_U = 22, S_T, S_ZU2, S_TV, S_X1, S_X, S_GX, S_GX2, S_Y, S_Y2, S_CAND,
  S_CAND2, S_RT, S_RT2, S_SQ, S_SQ2, S_D, S_D2, S_A, S_B,
  K5_TAB2 = S_FI,                    // the second table a^k: K5_TAB2 + k
  K5_SLOTS = 60,
  // operands only: H2cConsts' Fp2 constants from sswu_a on, then one
  K_A = K5_SLOTS, K_B, K_Z, K_MBA, K_BZA, K_X0, K_VSUM, K_USUM, K_C2,
  K_C3, K_BG2, K_ROOT0, K_PSI_CX = K_ROOT0 + 4, K_PSI_CY, K_PSI2_CX,
  K_PSI2_CY, K_ONE
};
static_assert(S_P1 + 3 <= S_U && S_B < S_FN && S_DB + 3 == S_FN &&
              K5_TAB2 + 16 == K5_SLOTS && S_Z3 == S_X3 + 2, "slot layout");
static_assert(offsetof(H2cConsts, psi2_cy) ==
              offsetof(H2cConsts, sswu_a) + (K_PSI2_CY - K_A) * sizeof(Fp2),
              "H2cConsts' Fp2 constants are contiguous from sswu_a");

K5_SHARED uint32_t k5_slot[K5_SLOTS * 2 * GW * K5_BLOCK];
// each thread's words of p, then its masks Half::above and Half::below
K5_SHARED uint32_t k5_p[(GW + 2) * K5_BLOCK];

FG_INL Half k5_half() {
  Half h;
  const uint32_t tid = K5_TID;
  h.lane = tid % 32u;
  h.k = h.lane % GT;
  h.mask = ((1u << GT) - 1u) << (h.lane - h.k);
#pragma unroll
  for (int v = 0; v < GW; ++v) h.p[v] = k5_p[v * K5_BLOCK + tid];
  h.above = k5_p[GW * K5_BLOCK + tid];
  h.below = k5_p[(GW + 1) * K5_BLOCK + tid];
  return h;
}

// word v (c0's GW words, then c1's) of slot s in this thread's column
FG_INL uint32_t& k5_word(int s, int v) {
  return k5_slot[(s * 2 * GW + v) * K5_BLOCK + K5_TID];
}

FG_INL void k5_ld(F2g& r, int s, const Half& h) {
  if (s < K5_SLOTS) {
#pragma unroll
    for (int v = 0; v < GW; ++v) {
      r.c0.w[v] = k5_word(s, v);
      r.c1.w[v] = k5_word(s, GW + v);
    }
  } else if (s == K_ONE) {
    fg_slice(r.c0, C.one, h);
    fg_zero(r.c1);
  } else {
    const Fp2& c = (&HC.sswu_a)[s - K_A];
    fg_slice(r.c0, c.c0, h);
    fg_slice(r.c1, c.c1, h);
  }
}

FG_INL void k5_st(int s, const F2g& a) {
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    k5_word(s, v) = a.c0.w[v];
    k5_word(s, GW + v) = a.c1.w[v];
  }
}

FG_INL void k5_copy(int d, int a) {
  F2g x;
  k5_ld(x, a, k5_half());
  k5_st(d, x);
}

FG_INL void k5_zero(int d) {
#pragma unroll
  for (int v = 0; v < 2 * GW; ++v) k5_word(d, v) = 0u;
}

// One Fp2 operation on slots, out of line: the straight-line formulas
// below are sequences of these calls, which keeps the kernel's code small.
K5_FN void k5_mul(int d, int a, int b) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, b, h);
  f2g_mul(x, x, y, h);
  k5_st(d, x);
}

K5_FN void k5_sqr(int d, int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
  f2g_sqr(x, x, h);
  k5_st(d, x);
}

// two independent products, or squarings, side by side (their Fp
// products interleave); both results are stored after every load
K5_FN void k5_mul2(int d1, int a1, int b1, int d2, int a2, int b2) {
  const Half h = k5_half();
  F2g x[2], y[2];
  k5_ld(x[0], a1, h);
  k5_ld(y[0], b1, h);
  k5_ld(x[1], a2, h);
  k5_ld(y[1], b2, h);
  f2g_mul_n<2>(x, x, y, h);
  k5_st(d1, x[0]);
  k5_st(d2, x[1]);
}

K5_FN void k5_sqr2(int d1, int a1, int d2, int a2) {
  const Half h = k5_half();
  F2g x[2];
  k5_ld(x[0], a1, h);
  k5_ld(x[1], a2, h);
  f2g_sqr_n<2>(x, x, h);
  k5_st(d1, x[0]);
  k5_st(d2, x[1]);
}

K5_FN void k5_add(int d, int a, int b) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, b, h);
  f2g_add(x, x, y, h);
  k5_st(d, x);
}

K5_FN void k5_sub(int d, int a, int b) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, b, h);
  f2g_sub(x, x, y, h);
  k5_st(d, x);
}

K5_FN void k5_neg(int d, int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
  f2g_neg(x, x, h);
  k5_st(d, x);
}

K5_FN void k5_conj(int d, int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
  f2g_conj(x, x, h);
  k5_st(d, x);
}

// Fp products on the c0 words of slots: the steps of an inversion
K5_FN void k5_fmul(int d, int a, int b) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, b, h);
  fg_mul(x.c0, x.c0, y.c0, h);
  k5_st(d, x);
}

// c0 of D = a0^2 + a1^2, the norm of A
K5_FN void k5_norm(int d, int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
  Fg p[2] = {x.c0, x.c1}, q[2] = {x.c0, x.c1}, n[2];
  fg_mul_n<2>(n, p, q, h);
  fg_add(x.c0, n[0], n[1], h);
  k5_st(d, x);
}

// D = (a0·t, -a1·t) with t the c0 of slot T
K5_FN void k5_scale_conj(int d, int a, int t) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, t, h);
  Fg p[2] = {x.c0, x.c1}, q[2] = {y.c0, y.c0}, n[2];
  fg_mul_n<2>(n, p, q, h);
  x.c0 = n[0];
  fg_neg(x.c1, n[1], h);
  k5_st(d, x);
}

K5_FN uint32_t k5_is_zero(int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
  return f2g_is_zero(x, h);
}

K5_FN uint32_t k5_eq(int a, int b) {
  const Half h = k5_half();
  F2g x, y;
  k5_ld(x, a, h);
  k5_ld(y, b, h);
  return f2g_eq(x, y, h);
}

// RFC 9380 sgn0: sgn0(c0) | (c0 == 0 & sgn0(c1)), from the canonical
// integers (two products by the plain integer 1)
K5_FN uint32_t k5_sgn0(int a) {
  const Half h = k5_half();
  F2g x;
  k5_ld(x, a, h);
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

// a1^((p^2+7)/16) into D1 and a2^((p^2+7)/16) into D2 side by side, as
// f2_pow_sqrt computes each: the tables a^1..a^15 in slots 1..15 and
// K5_TAB2 + 1..15 (a^k = a^(k-q)·a^q, q the largest power of two below
// k), then per 4-bit window four squarings and, for a nonzero digit, one
// product. The digits are the same on every thread.
FG_INL void k5_pow_sqrt2(int d1, int a1, int d2, int a2) {
  k5_copy(1, a1);
  k5_copy(K5_TAB2 + 1, a2);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    int q = 1;
    while (2 * q < k) q *= 2;
    k5_mul2(k, k - q, q, K5_TAB2 + k, K5_TAB2 + k - q, K5_TAB2 + q);
  }
  const int n = (int)HC.n_sqrt;
  const int lead = n % 4 == 0 ? 4 : n % 4;  // bits of the top window
  int dg = 0;
  for (int i = 0; i < lead; ++i) dg = 2 * dg + (int)HC.sqrt_bits[i];
  k5_copy(d1, dg);
  k5_copy(d2, K5_TAB2 + dg);
#pragma unroll 1
  for (int i = lead; i < n; i += 4) {
    dg = 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      k5_sqr2(d1, d1, d2, d2);
      dg = 2 * dg + (int)HC.sqrt_bits[i + j];
    }
    if (dg) k5_mul2(d1, d1, dg, d2, d2, K5_TAB2 + dg);
  }
}

// fp.cuh f2_inv into D: (a0 - a1·u) / (a0^2 + a1^2), the norm inverted
// by Fermat, a^(p-2), MSB-first square-and-multiply over the bits of p-2;
// one out-of-line product per step (a branch around the products inside
// one function would make ptxas synchronise the warp at every shuffle)
FG_INL void k5_inv(int d, int a) {
  k5_norm(S_FN, a);
  k5_copy(S_FI, K_ONE);
#pragma unroll 1
  for (uint32_t i = 0; i < C.n_pm2; ++i) {
    k5_fmul(S_FI, S_FI, S_FI);
    if (C.pm2[i]) k5_fmul(S_FI, S_FI, S_FN);
  }
  k5_scale_conj(d, a, S_FI);
}

// 2P (curve.cuh pt_dbl) from point slots A into D (which may be A), on
// temporaries 0..8 (an addition's first nine, dead whenever it doubles);
// independent products run side by side. The infinity flag passes
// through.
FG_INL void k5_dbl(int d, int a) {
  enum { A = 0, B, C_, D, E, T, X3, Y3, Z3 };
  k5_sqr2(A, a, B, a + 1);
  k5_add(T, a, B);
  k5_sqr2(T, T, C_, B);
  // D = 2((X + B)^2 - (A + C)), E = 3A
  k5_add(D, A, C_);
  k5_sub(D, T, D);
  k5_add(D, D, D);
  k5_add(E, A, A);
  k5_add(E, E, A);
  // X3 = E^2 - 2D
  k5_sqr(T, E);
  k5_add(X3, D, D);
  k5_sub(X3, T, X3);
  // Y3 = E(D - X3) - 8C, Z3 = 2YZ
  k5_sub(T, D, X3);
  k5_mul2(Y3, E, T, Z3, a + 1, a + 2);
  k5_add(T, C_, C_);
  k5_add(T, T, T);
  k5_add(T, T, T);
  k5_sub(Y3, Y3, T);
  k5_add(Z3, Z3, Z3);
  k5_copy(d, X3);
  k5_copy(d + 1, Y3);
  k5_copy(d + 2, Z3);
}

FG_INL void k5_copy3(int d, int a) {
  if (d == a) return;
  for (int i = 0; i < 3; ++i) k5_copy(d + i, a + i);
}

FG_INL void k5_pt_neg(int d, int a) {
  k5_copy(d, a);
  k5_neg(d + 1, a + 1);
  k5_copy(d + 2, a + 2);
}

FG_INL uint32_t k5_warp_any(uint32_t pred) {
  return __any_sync(FG_WARP, pred ? 1 : 0) ? 1u : 0u;
}

// Complete P + Q (curve.cuh pt_add: the same formulas and cases) on point
// slots; returns the sum's infinity flag. R may be P or Q. The warp runs
// the general formula, and the doubling, where any of its checks needs
// them (every shuffle inside needs the whole warp); each check then
// copies its own case's result: Q where P is infinity, P where Q is, 2P
// where H = 0 and S = 0, infinity where H = 0 alone, else the sum.
FG_INL uint32_t k5_pt_add(int r, int p, uint32_t pinf, int q,
                          uint32_t qinf) {
  const uint32_t gen = !pinf && !qinf ? 1u : 0u;
  uint32_t hz = 0u, sz = 0u;
  if (k5_warp_any(gen)) {
    k5_sqr2(S_Z1Z1, p + 2, S_Z2Z2, q + 2);
    k5_mul2(S_U1, p, S_Z2Z2, S_U2, q, S_Z1Z1);
    k5_mul2(S_TT, p + 1, q + 2, S_S2, q + 1, p + 2);
    k5_mul2(S_S1, S_TT, S_Z2Z2, S_S2, S_S2, S_Z1Z1);
    k5_sub(S_H, S_U2, S_U1);
    k5_sub(S_SD, S_S2, S_S1);
    hz = k5_is_zero(S_H);
    sz = k5_is_zero(S_SD);
    if (k5_warp_any(gen & (hz ^ 1u))) {
      // I = 4H^2, J = H·I, r = 2S, V = U1·I
      k5_add(S_RR, S_SD, S_SD);
      k5_sqr(S_I, S_H);
      k5_add(S_I, S_I, S_I);
      k5_add(S_I, S_I, S_I);
      k5_mul2(S_J, S_H, S_I, S_V, S_U1, S_I);
      // X3 = r^2 - (J + 2V); beside r^2, (Z1 + Z2)^2 for Z3
      k5_add(S_Z3, p + 2, q + 2);
      k5_sqr2(S_X3, S_RR, S_Z3, S_Z3);
      k5_add(S_TT, S_V, S_V);
      k5_add(S_TT, S_J, S_TT);
      k5_sub(S_X3, S_X3, S_TT);
      // Y3 = r(V - X3) - 2·S1·J (S1·J into U2, dead)
      k5_sub(S_TT, S_V, S_X3);
      k5_mul2(S_Y3, S_RR, S_TT, S_U2, S_S1, S_J);
      k5_add(S_U2, S_U2, S_U2);
      k5_sub(S_Y3, S_Y3, S_U2);
      // Z3 = ((Z1 + Z2)^2 - (Z1Z1 + Z2Z2))·H
      k5_add(S_TT, S_Z1Z1, S_Z2Z2);
      k5_sub(S_TT, S_Z3, S_TT);
      k5_mul(S_Z3, S_TT, S_H);
    }
    if (k5_warp_any(gen & hz & sz)) k5_dbl(S_DB, p);
  }
  if (pinf) {
    k5_copy3(r, q);
    return qinf;
  }
  if (qinf) {
    k5_copy3(r, p);
    return 0u;
  }
  if (hz && sz) {
    k5_copy3(r, S_DB);
    return 0u;
  }
  if (hz) {
    k5_copy(r, K_ONE);
    k5_copy(r + 1, K_ONE);
    k5_zero(r + 2);
    return 1u;
  }
  k5_copy3(r, S_X3);
  return 0u;
}

// psi(X, Y, Z) = (cx·conj(X), cy·conj(Y), conj(Z)); R may be P
FG_INL void k5_psi(int r, int p) {
  k5_conj(S_TT, p);
  k5_mul(r, S_TT, K_PSI_CX);
  k5_conj(S_TT, p + 1);
  k5_mul(r + 1, S_TT, K_PSI_CY);
  k5_conj(r + 2, p + 2);
}

FG_INL void k5_psi2(int r, int p) {
  k5_mul(r, p, K_PSI2_CX);
  k5_mul(r + 1, p + 1, K_PSI2_CY);
  k5_copy(r + 2, p + 2);
}

// [h_eff]P = [x^2-x-1]P + psi([x-1]P) + psi^2([2]P) into R (not P), the
// steps of the one-thread clear_cofactor: T1 = [x]P, T2 = [x]T1 (one
// loop, so the chain's code exists once; [x] is [|x|] MSB first, 63
// doublings and 5 additions, then negated), then the five additions.
FG_INL uint32_t k5_clear(int r, int p, uint32_t pinf) {
  uint32_t t1inf = 0u, t2inf = 0u;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int src = pass ? S_T1 : p;
    const uint32_t sinf = pass ? t1inf : pinf;
    k5_copy3(S_ACC, src);
    uint32_t ainf = sinf;
#pragma unroll 1
    for (uint32_t i = 1; i < C.n_x; ++i) {
      k5_dbl(S_ACC, S_ACC);
      if (C.bits_x[i]) ainf = k5_pt_add(S_ACC, S_ACC, ainf, src, sinf);
    }
    k5_pt_neg(pass ? S_T2 : S_T1, S_ACC);
    if (pass) t2inf = ainf;
    else t1inf = ainf;
  }
  k5_pt_neg(S_NP, p);
  k5_pt_neg(S_PA, S_T1);
  uint32_t ainf = k5_pt_add(S_PA, S_T2, t2inf, S_PA, t1inf);
  ainf = k5_pt_add(S_PA, S_PA, ainf, S_NP, pinf);
  uint32_t binf = k5_pt_add(S_PB, S_T1, t1inf, S_NP, pinf);
  k5_psi(S_PB, S_PB);
  ainf = k5_pt_add(S_PA, S_PA, ainf, S_PB, binf);
  k5_dbl(S_PB, p);
  binf = pinf;
  k5_psi2(S_PB, S_PB);
  return k5_pt_add(r, S_PA, ainf, S_PB, binf);
}

// g'(x) = x^3 + A'x + B' on E' for two x side by side
FG_INL void k5_g_prime2(int r1, int x1, int r2, int x2) {
  k5_sqr2(S_RT, x1, S_RT2, x2);
  k5_mul2(S_RT, S_RT, x1, S_RT2, S_RT2, x2);
  k5_mul2(S_SQ, K_A, x1, S_SQ2, K_A, x2);
  k5_add(S_RT, S_RT, S_SQ);
  k5_add(S_RT2, S_RT2, S_SQ2);
  k5_add(r1, S_RT, K_B);
  k5_add(r2, S_RT2, K_B);
}

// The square roots of A1 and A2 side by side, as sqrt_f2 takes each: R =
// the candidate times the first 4th root of unity whose square is A (the
// candidate itself where none is). Returns 1 iff A1 is a square.
FG_INL uint32_t k5_sqrt2(int r1, int a1, int r2, int a2) {
  k5_pow_sqrt2(S_CAND, a1, S_CAND2, a2);
  uint32_t found1 = 0u, found2 = 0u;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    k5_mul2(S_RT, S_CAND, K_ROOT0 + i, S_RT2, S_CAND2, K_ROOT0 + i);
    k5_sqr2(S_SQ, S_RT, S_SQ2, S_RT2);
    const uint32_t hit1 = k5_eq(S_SQ, a1), hit2 = k5_eq(S_SQ2, a2);
    if (i == 0 || (hit1 && !found1)) k5_copy(r1, S_RT);
    if (i == 0 || (hit2 && !found2)) k5_copy(r2, S_RT2);
    found1 |= hit1;
    found2 |= hit2;
  }
  return found1;
}

// This half-group's u (slot S_U) -> a Jacobian point on E2 in S_P0..+2
// before clearing, as the one-thread map_to_curve did: SWU onto E'
// (affine), then the 3-isogeny with Z = d = x - x0, which needs no
// inversion:
//   X = c2·(x·d^2 + V·d + U),  Y = c3·y·(d^3 - V·d - 2U)
// d = 0, a kernel point of the isogeny, maps to infinity (returns 1).
// A branch on u (tv == 0, the sign flip) runs where any half-group of
// the warp takes it, and each half-group then copies its own case's
// value. Both candidates x1 and x2 = Z·u^2·x1 and their square roots are
// computed side by side, as hash_to_g2_plain computes them: a warp of
// eight maps needs the second root in all but 1/256 of warps, and the two
// exponentiations in one pass take far less than two in turn.
FG_INL uint32_t k5_map() {
  k5_sqr(S_T, S_U);
  k5_mul(S_ZU2, K_Z, S_T);
  k5_sqr(S_TV, S_ZU2);
  k5_add(S_TV, S_TV, S_ZU2);
  const uint32_t tvz = k5_is_zero(S_TV);
  if (k5_warp_any(tvz ^ 1u)) {
    k5_inv(S_T, S_TV);
    k5_add(S_T, K_ONE, S_T);
    k5_mul(S_X1, K_MBA, S_T);
  }
  if (tvz) k5_copy(S_X1, K_BZA);
  // g'(x1) a square: x = x1; else x = Z·u^2·x1 and its root
  k5_mul(S_X, S_ZU2, S_X1);
  k5_g_prime2(S_GX, S_X1, S_GX2, S_X);
  const uint32_t sq1 = k5_sqrt2(S_Y, S_GX, S_Y2, S_GX2);
  if (!sq1) k5_copy(S_Y, S_Y2);
  const int x = sq1 ? S_X1 : S_X;
  k5_neg(S_T, S_Y);
  if (k5_sgn0(S_U) != k5_sgn0(S_Y)) k5_copy(S_Y, S_T);
  k5_sub(S_D, x, K_X0);
  k5_sqr(S_D2, S_D);
  k5_mul(S_A, x, S_D2);
  k5_mul(S_B, K_VSUM, S_D);
  k5_add(S_A, S_A, S_B);
  k5_add(S_A, S_A, K_USUM);
  k5_mul(S_P0, K_C2, S_A);
  k5_mul(S_A, S_D2, S_D);
  k5_add(S_T, K_USUM, K_USUM);
  k5_add(S_T, S_B, S_T);
  k5_sub(S_A, S_A, S_T);
  k5_mul(S_A, S_Y, S_A);
  k5_mul(S_P0 + 1, K_C3, S_A);
  k5_copy(S_P0 + 2, S_D);
  return k5_is_zero(S_D);
}

// (X/Z^2, Y/Z^3) into AX, AY; Z is taken as one at infinity
FG_INL void k5_affine(int ax, int ay, int p, uint32_t pinf) {
  k5_copy(0, pinf ? K_ONE : p + 2);
  k5_inv(1, 0);
  k5_sqr(2, 1);
  k5_mul(ax, p, 2);
  k5_mul(3, 2, 1);
  k5_mul(ay, p + 1, 3);
}

// One check on the calling thread's group: u (2, 2, 12) -> xy (2, 2, 12),
// *inf, unless live is 0 (a group past n: it computes as the warp's first
// check does and stores nothing, so that the warp stays whole for every
// shuffle and takes no branch of its own). Half-group h maps u_h; the
// halves swap their points by shuffles and both run the sum, clearing and
// to-affine (the same values); half 0 stores x, half 1 y.
FG_INL void k5_check(const uint32_t* u, uint32_t* xy, uint32_t* inf,
                     uint32_t live) {
  const uint32_t tid = K5_TID, lane = tid % 32u;
  const uint32_t k = lane % GT, half = (lane / GT) % 2u;
#pragma unroll
  for (int v = 0; v < GW; ++v) k5_p[v * K5_BLOCK + tid] = C.p.w[GW * k + v];
  k5_p[GW * K5_BLOCK + tid] = k == GT - 1 ? 0u : 0xFFFFFFFFu;
  k5_p[(GW + 1) * K5_BLOCK + tid] = k == 0 ? 0u : 0xFFFFFFFFu;
  const Half h = k5_half();
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    k5_word(S_U, v) = u[half * 2 * NW + GW * k + v];
    k5_word(S_U, GW + v) = u[half * 2 * NW + NW + GW * k + v];
  }
  const uint32_t minf = k5_map();
  const uint32_t oinf = __shfl_xor_sync(FG_WARP, minf, GT, K5_GROUP);
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v) {
      const uint32_t own = k5_word(S_P0 + s, v);
      const uint32_t other = __shfl_xor_sync(FG_WARP, own, GT, K5_GROUP);
      k5_word(S_P0 + s, v) = half ? other : own;
      k5_word(S_P1 + s, v) = half ? own : other;
    }
  uint32_t qinf = k5_pt_add(S_P0, S_P0, half ? oinf : minf, S_P1,
                            half ? minf : oinf);
  qinf = k5_clear(S_P1, S_P0, qinf);
  k5_affine(S_T1, S_T2, S_P1, qinf);
  if (!live) return;
  F2g o;
  k5_ld(o, half ? S_T2 : S_T1, h);
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    xy[half * 2 * NW + GW * k + v] = qinf ? 0u : o.c0.w[v];
    xy[half * 2 * NW + NW + GW * k + v] = qinf ? 0u : o.c1.w[v];
  }
  if (lane % K5_GROUP == 0) *inf = qinf;
}

#endif  // __CUDACC__ || H2C_WARP_EMULATION

#if defined(__CUDACC__)

// No thread leaves before the end: a group past n (in the last warp)
// runs on the warp's first check and stores nothing, so every shuffle of
// the full warp names only threads that are there.
__global__ void __launch_bounds__(K5_BLOCK)
hash_to_g2_kernel(const uint32_t* __restrict__ u, uint32_t* __restrict__ xy,
                  uint32_t* __restrict__ inf, int n) {
  const int check = (blockIdx.x * K5_BLOCK + threadIdx.x) / K5_GROUP;
  const uint32_t live = check < n ? 1u : 0u;
  const int src = live ? check : blockIdx.x * (K5_BLOCK / K5_GROUP);
  k5_check(u + (size_t)src * 4 * NW, xy + (size_t)src * 4 * NW, inf + src,
           live);
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

// K5's grid: n checks of K5_GROUP threads, in warps of K5_BLOCK
static int k5_grid(int n) {
  return (int)(((int64_t)n * K5_GROUP + K5_BLOCK - 1) / K5_BLOCK);
}

extern "C" int hash_to_g2_group() { return K5_GROUP; }

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
  hash_to_g2_kernel<<<k5_grid(n), K5_BLOCK, 0, s>>>(
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
