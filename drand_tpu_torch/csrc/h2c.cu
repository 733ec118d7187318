// The wire path's device prep on Hopper: hash-to-G2 of message u-values
// (K5, a group of eight threads per check) and decompression of
// compressed G2 signatures (K6, a half-group of four threads per check).
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
// [x]-chain, skipped where no check of the warp is on the curve); inputs
// and outputs are under 200 bytes per check. Each check is one long
// dependent chain, so the time is that chain's latency, and the card is
// far from full.
//
// Both kernels run on the cooperative arithmetic of fp_group.cuh and the
// slot machinery of g2_group.cuh: an Fp value's 12 words are spread over a
// half-group of four threads, which compute each product together; every
// shuffle and ballot is over the whole converged warp, a branch on a
// check's data runs where any check of the warp takes it and each check
// then copies its own case's value, and a group past n runs on the warp's
// first check and stores nothing (g2_group.cuh says why).
//
// K5 runs each check on K5_GROUP = 8 threads: the two halves of a group
// run the two maps at once, map(u0) and map(u1); then each half takes the
// other's point by shuffles, and both compute the same sum, clearing and
// to-affine (the warp executes their instructions once), half 0 storing x
// and half 1 storing y. Both SSWU candidates and their square roots are
// computed side by side, as hash_to_g2_plain computes them: eight maps to
// a warp need the second root in all but 1/256 of warps, so a warp took it
// anyway. A bucket of 512 checks is 4,096 threads: one warp a block on
// 128 SMs.
//
// K6 runs each check on K6_GROUP = 4 threads, a half-group: eight checks
// a warp, a bucket of 512 on 64 SMs. The root (one exponentiation a check,
// 4-bit windows), its four corrections, the sign rule and the subgroup
// check are decompress_plain's (ops/h2c.py) product for product; the
// subgroup check runs where any check of the warp has x on the curve.
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
#include <stddef.h>

#include "fp.cuh"

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

#if defined(__CUDACC__) || defined(GG_WARP_EMULATION)
#include "fp_group.cuh"

#define H2C_BLOCK 32             // one warp: four K5 checks, eight K6 checks
#define K5_GROUP (2 * GT)        // threads per K5 check: two half-groups
#define K6_GROUP GT              // threads per K6 check: one half-group

// g2_group.cuh's layout for both kernels (the enum below names the slots)
#define GG_BLOCK H2C_BLOCK
#define GG_SLOTS 60
#define GG_DB 40
#define GG_NORM 43
#define GG_RECIP 44
#define GG_ONE 79

// operands from GG_SLOTS on: H2cConsts' Fp2 constants from sswu_a on
FG_INL void gg_ld_const(F2g& r, int s, const Half& h) {
  const Fp2& c = (&HC.sswu_a)[s - GG_SLOTS];
  fg_slice(r.c0, c.c0, h);
  fg_slice(r.c1, c.c1, h);
}

#include "g2_group.cuh"

// Fp2 slots of a thread's shared-memory column past the addition's
// temporaries (0..15). A point takes three consecutive slots (x, y, z);
// its infinity flag is a register of the calling code. K5: the map's
// slots lie over the clearing's points, which are dead while the maps
// run; the square roots' window tables (a^1..a^15 in slots 1..15 and
// K5_TAB2 + 1..15) over the addition's temporaries and after every other
// slot. K6: the point Q = (x, y, 1), psi(Q), [x]Q and the [x] chain's
// accumulator, then x^3 + b, the root candidate, its corrections and the
// cross-multiplication; its window table in slots 1..15.
enum : int {
  S_P0 = 16, S_P1 = 19,              // map(u0), map(u1); then the sum
  S_T1 = 22, S_T2 = 25, S_NP = 28, S_PA = 31, S_PB = 34, S_ACC = 37,
  S_DB = GG_DB,                      // an addition's doubling case
  S_FN = GG_NORM, S_FI = GG_RECIP,   // an inversion's norm and its inverse
  S_U = 22, S_T, S_ZU2, S_TV, S_X1, S_X, S_GX, S_GX2, S_Y, S_Y2, S_CAND,
  S_CAND2, S_RT, S_RT2, S_SQ, S_SQ2, S_D, S_D2, S_A, S_B,
  K5_TAB2 = S_FI,                    // the second table a^k: K5_TAB2 + k
  K5_SLOTS = 60,
  S6_Q = 16, S6_L = 19, S6_R = 22, S6_ACC = 25, S6_G = 28, S6_CAND,
  S6_RT, S6_SQ, S6_NY, S6_Z1, S6_Z2, S6_A, S6_B,
  // operands only: H2cConsts' Fp2 constants from sswu_a on, then one
  K_A = K5_SLOTS, K_B, K_Z, K_MBA, K_BZA, K_X0, K_VSUM, K_USUM, K_C2,
  K_C3, K_BG2, K_ROOT0, K_PSI_CX = K_ROOT0 + 4, K_PSI_CY, K_PSI2_CX,
  K_PSI2_CY, K_ONE
};
static_assert(S_P1 + 3 <= S_U && S_B < S_FN && S_DB + 3 == S_FN &&
              K5_TAB2 + 16 == K5_SLOTS && S_Z3 == S_X3 + 2 &&
              (int)S6_Q >= (int)GG_TEMPS && (int)S6_B < (int)S_DB,
              "slot layout");
static_assert(K5_SLOTS == GG_SLOTS && K_ONE == GG_ONE, "g2_group layout");
static_assert(offsetof(H2cConsts, psi2_cy) ==
              offsetof(H2cConsts, sswu_a) + (K_PSI2_CY - K_A) * sizeof(Fp2),
              "H2cConsts' Fp2 constants are contiguous from sswu_a");

// ---------------------------------------------------------------------------
// K5: one check on a group of K5_GROUP threads
// ---------------------------------------------------------------------------

// [h_eff]P = [x^2-x-1]P + psi([x-1]P) + psi^2([2]P) into R (not P), the
// steps of the one-thread clear_cofactor: T1 = [x]P, T2 = [x]T1 (one
// loop, so the chain's code exists once), then the five additions.
FG_INL uint32_t k5_clear(int r, int p, uint32_t pinf) {
  uint32_t t1inf = 0u, t2inf = 0u;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int src = pass ? S_T1 : p;
    const uint32_t sinf = pass ? t1inf : pinf;
    const uint32_t ainf = gg_mul_x(pass ? S_T2 : S_T1, src, sinf, S_ACC);
    if (pass) t2inf = ainf;
    else t1inf = ainf;
  }
  gg_pt_neg(S_NP, p);
  gg_pt_neg(S_PA, S_T1);
  uint32_t ainf = gg_pt_add(S_PA, S_T2, t2inf, S_PA, t1inf);
  ainf = gg_pt_add(S_PA, S_PA, ainf, S_NP, pinf);
  uint32_t binf = gg_pt_add(S_PB, S_T1, t1inf, S_NP, pinf);
  gg_psi(S_PB, S_PB, K_PSI_CX, K_PSI_CY);
  ainf = gg_pt_add(S_PA, S_PA, ainf, S_PB, binf);
  gg_dbl(S_PB, p);
  binf = pinf;
  gg_psi2(S_PB, S_PB, K_PSI2_CX, K_PSI2_CY);
  return gg_pt_add(r, S_PA, ainf, S_PB, binf);
}

// g'(x) = x^3 + A'x + B' on E' for two x side by side
FG_INL void k5_g_prime2(int r1, int x1, int r2, int x2) {
  gg_sqr2(S_RT, x1, S_RT2, x2);
  gg_mul2(S_RT, S_RT, x1, S_RT2, S_RT2, x2);
  gg_mul2(S_SQ, K_A, x1, S_SQ2, K_A, x2);
  gg_add(S_RT, S_RT, S_SQ);
  gg_add(S_RT2, S_RT2, S_SQ2);
  gg_add(r1, S_RT, K_B);
  gg_add(r2, S_RT2, K_B);
}

// The square roots of A1 and A2 side by side, as sqrt_f2 takes each: R =
// the candidate a^((p^2+7)/16) times the first 4th root of unity whose
// square is A (the candidate itself where none is). Returns 1 iff A1 is a
// square.
FG_INL uint32_t k5_sqrt2(int r1, int a1, int r2, int a2) {
  gg_pow2(S_CAND, a1, S_CAND2, a2, K5_TAB2, HC.sqrt_bits, (int)HC.n_sqrt);
  uint32_t found1 = 0u, found2 = 0u;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    gg_mul2(S_RT, S_CAND, K_ROOT0 + i, S_RT2, S_CAND2, K_ROOT0 + i);
    gg_sqr2(S_SQ, S_RT, S_SQ2, S_RT2);
    const uint32_t hit1 = gg_eq(S_SQ, a1), hit2 = gg_eq(S_SQ2, a2);
    if (i == 0 || (hit1 && !found1)) gg_copy(r1, S_RT);
    if (i == 0 || (hit2 && !found2)) gg_copy(r2, S_RT2);
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
  gg_sqr(S_T, S_U);
  gg_mul(S_ZU2, K_Z, S_T);
  gg_sqr(S_TV, S_ZU2);
  gg_add(S_TV, S_TV, S_ZU2);
  const uint32_t tvz = gg_is_zero(S_TV);
  if (gg_warp_any(tvz ^ 1u)) {
    gg_inv(S_T, S_TV);
    gg_add(S_T, K_ONE, S_T);
    gg_mul(S_X1, K_MBA, S_T);
  }
  if (tvz) gg_copy(S_X1, K_BZA);
  // g'(x1) a square: x = x1; else x = Z·u^2·x1 and its root
  gg_mul(S_X, S_ZU2, S_X1);
  k5_g_prime2(S_GX, S_X1, S_GX2, S_X);
  const uint32_t sq1 = k5_sqrt2(S_Y, S_GX, S_Y2, S_GX2);
  if (!sq1) gg_copy(S_Y, S_Y2);
  const int x = sq1 ? S_X1 : S_X;
  gg_neg(S_T, S_Y);
  if (gg_sgn0(S_U) != gg_sgn0(S_Y)) gg_copy(S_Y, S_T);
  gg_sub(S_D, x, K_X0);
  gg_sqr(S_D2, S_D);
  gg_mul(S_A, x, S_D2);
  gg_mul(S_B, K_VSUM, S_D);
  gg_add(S_A, S_A, S_B);
  gg_add(S_A, S_A, K_USUM);
  gg_mul(S_P0, K_C2, S_A);
  gg_mul(S_A, S_D2, S_D);
  gg_add(S_T, K_USUM, K_USUM);
  gg_add(S_T, S_B, S_T);
  gg_sub(S_A, S_A, S_T);
  gg_mul(S_A, S_Y, S_A);
  gg_mul(S_P0 + 1, K_C3, S_A);
  gg_copy(S_P0 + 2, S_D);
  return gg_is_zero(S_D);
}

// One check on the calling thread's group: u (2, 2, 12) -> xy (2, 2, 12),
// *inf, unless live is 0 (a group past n: it computes as the warp's first
// check does and stores nothing, so that the warp stays whole for every
// shuffle and takes no branch of its own). Half-group h maps u_h; the
// halves swap their points by shuffles and both run the sum, clearing and
// to-affine (the same values); half 0 stores x, half 1 y.
FG_INL void k5_check(const uint32_t* u, uint32_t* xy, uint32_t* inf,
                     uint32_t live) {
  const uint32_t lane = GG_TID % 32u;
  const uint32_t k = lane % GT, half = (lane / GT) % 2u;
  gg_init();
  const Half h = gg_half();
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    gg_word(S_U, v) = u[half * 2 * NW + GW * k + v];
    gg_word(S_U, GW + v) = u[half * 2 * NW + NW + GW * k + v];
  }
  uint32_t qinf = gg_swap_add(S_P0, S_P1, k5_map(), half, GT, K5_GROUP);
  qinf = k5_clear(S_P1, S_P0, qinf);
  gg_affine(S_T1, S_T2, S_P1, qinf);
  if (!live) return;
  F2g o;
  gg_ld(o, half ? S_T2 : S_T1, h);
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    xy[half * 2 * NW + GW * k + v] = qinf ? 0u : o.c0.w[v];
    xy[half * 2 * NW + NW + GW * k + v] = qinf ? 0u : o.c1.w[v];
  }
  if (lane % K5_GROUP == 0) *inf = qinf;
}

// ---------------------------------------------------------------------------
// K6: one check on a half-group
// ---------------------------------------------------------------------------

// 1 iff a > b as integers (the same answer on the half-group's threads):
// each thread compares its words from the top, and the highest thread
// whose slices differ decides
FG_INL uint32_t fg_gt(const Fg& a, const Fg& b, const Half& h) {
  uint32_t gt = 0u, lt = 0u;
#pragma unroll
  for (int v = GW - 1; v >= 0; --v) {
    const uint32_t open = (gt | lt) ^ 1u;
    gt |= open & (a.w[v] > b.w[v] ? 1u : 0u);
    lt |= open & (a.w[v] < b.w[v] ? 1u : 0u);
  }
  return fg_ballot(gt, h) > fg_ballot(lt, h) ? 1u : 0u;
}

// The zcash sign rule, lex_largest_f2: y > -y lexicographically, c1 >
// (p-1)/2, or c1 == 0 and c0 > (p-1)/2, from the canonical integers (two
// products by the plain integer 1)
GG_OP uint32_t k6_lex_largest(int a) {
  const Half h = gg_half();
  F2g x;
  gg_ld(x, a, h);
  Fg p[2] = {x.c0, x.c1}, one[2], c[2], half, s;
  fg_zero(one[0]);
  one[0].w[0] = ~h.below & 1u;
  one[1] = one[0];
  fg_mul_n<2>(c, p, one, h);
  fg_slice(half, HC.half_p, h);
  const uint32_t c1_zero = fg_mask(fg_is_zero(c[1], h));
#pragma unroll
  for (int v = 0; v < GW; ++v)
    s.w[v] = (c[0].w[v] & c1_zero) | (c[1].w[v] & ~c1_zero);
  return fg_gt(s, half, h);
}

// One check on the calling thread's half-group: x (2, 12), sign -> xy (2,
// 2, 12), *ok, unless live is 0 (a half-group past n: it computes as the
// warp's first check does and stores nothing). y = sqrt(x^3 + 4(1+u)) by
// the candidate and the first of the four corrections whose square is
// x^3 + 4(1+u); flipped to the sign flag's lexicographic choice; then
// psi(Q) == [x]Q by Jacobian cross-multiplication, where any check of the
// warp is on the curve. A check off the curve or outside G2 stores zeros.
FG_INL void k6_check(const uint32_t* x, int32_t sign, uint32_t* xy,
                     uint32_t* ok_out, uint32_t live) {
  const uint32_t k = GG_TID % 32u % GT;
  gg_init();
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    gg_word(S6_Q, v) = x[GW * k + v];
    gg_word(S6_Q, GW + v) = x[NW + GW * k + v];
  }
  gg_sqr(S6_G, S6_Q);
  gg_mul(S6_G, S6_G, S6_Q);
  gg_add(S6_G, S6_G, K_BG2);
  gg_pow(S6_CAND, S6_G, HC.sqrt_bits, (int)HC.n_sqrt);
  uint32_t found = 0u;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    gg_mul(S6_RT, S6_CAND, K_ROOT0 + i);
    gg_sqr(S6_SQ, S6_RT);
    const uint32_t hit = gg_eq(S6_SQ, S6_G);
    if (i == 0 || (hit && !found)) gg_copy(S6_Q + 1, S6_RT);
    found |= hit;
  }
  uint32_t ok = 0u;
  if (gg_warp_any(found)) {
    gg_neg(S6_NY, S6_Q + 1);
    if (k6_lex_largest(S6_Q + 1) != (sign != 0 ? 1u : 0u))
      gg_copy(S6_Q + 1, S6_NY);
    gg_copy(S6_Q + 2, K_ONE);
    gg_psi(S6_L, S6_Q, K_PSI_CX, K_PSI_CY);
    const uint32_t rinf = gg_mul_x(S6_R, S6_Q, 0u, S6_ACC);
    gg_sqr2(S6_Z1, S6_L + 2, S6_Z2, S6_R + 2);
    gg_mul2(S6_A, S6_L, S6_Z2, S6_B, S6_R, S6_Z1);
    const uint32_t ex = gg_eq(S6_A, S6_B);
    gg_mul2(S6_Z1, S6_Z1, S6_L + 2, S6_Z2, S6_Z2, S6_R + 2);
    gg_mul2(S6_A, S6_L + 1, S6_Z2, S6_B, S6_R + 1, S6_Z1);
    ok = found & ex & gg_eq(S6_A, S6_B) & (rinf ^ 1u);
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v)
      xy[c * 2 * NW + (v / GW) * NW + GW * k + v % GW] =
          ok ? gg_word(S6_Q + c, v) : 0u;
  if (k == 0) *ok_out = ok;
}

#endif  // __CUDACC__ || GG_WARP_EMULATION

#if defined(__CUDACC__)

// No thread leaves before the end: a group past n (in the last warp)
// runs on the warp's first check and stores nothing, so every shuffle of
// the full warp names only threads that are there.
__global__ void __launch_bounds__(H2C_BLOCK)
hash_to_g2_kernel(const uint32_t* __restrict__ u, uint32_t* __restrict__ xy,
                  uint32_t* __restrict__ inf, int n) {
  const int check = (blockIdx.x * H2C_BLOCK + threadIdx.x) / K5_GROUP;
  const uint32_t live = check < n ? 1u : 0u;
  const int src = live ? check : blockIdx.x * (H2C_BLOCK / K5_GROUP);
  k5_check(u + (size_t)src * 4 * NW, xy + (size_t)src * 4 * NW, inf + src,
           live);
}

__global__ void __launch_bounds__(H2C_BLOCK)
decompress_g2_kernel(const uint32_t* __restrict__ x,
                     const int32_t* __restrict__ sign,
                     uint32_t* __restrict__ xy, uint32_t* __restrict__ ok,
                     int n) {
  const int check = (blockIdx.x * H2C_BLOCK + threadIdx.x) / K6_GROUP;
  const uint32_t live = check < n ? 1u : 0u;
  const int src = live ? check : blockIdx.x * (H2C_BLOCK / K6_GROUP);
  k6_check(x + (size_t)src * 2 * NW, sign[src], xy + (size_t)src * 4 * NW,
           ok + src, live);
}

// a grid of n checks of `group` threads, in warps of H2C_BLOCK
static int h2c_grid(int n, int group) {
  return (int)(((int64_t)n * group + H2C_BLOCK - 1) / H2C_BLOCK);
}

extern "C" int hash_to_g2_group() { return K5_GROUP; }

extern "C" int decompress_g2_group() { return K6_GROUP; }

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
  hash_to_g2_kernel<<<h2c_grid(n, K5_GROUP), H2C_BLOCK, 0, s>>>(
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
  decompress_g2_kernel<<<h2c_grid(n, K6_GROUP), H2C_BLOCK, 0, s>>>(
      (const uint32_t*)x, (const int32_t*)sign, (uint32_t*)xy,
      (uint32_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
