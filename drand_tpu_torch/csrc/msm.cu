// Multi-scalar multiplication over G2 on Hopper: sum_i bits_i · P_i, the
// Lagrange recovery of a threshold signature (chain/beacon/chain.go:136)
// and the two sums of the wire-RLC combine, for k sums at once over the
// same mask and bits.
//
// Replaces the JAX package's ops/pallas_msm.py:_msm_kernel (per-lane
// double-and-add ladders on the TPU's 128 vector lanes, a log2(B)-step
// fold by lane rotation, an in-kernel to-affine). The lane width of 128
// and the rotation fold were TPU artefacts. Here each lane's ladder runs
// on a half-group of four threads (fp_group.cuh: each Fp value's 12 words
// spread three a thread, every product computed together), on the slot
// machinery of g2_group.cuh that K5 and K6 use:
//
//   msm_ladder_fold_kernel  a block is one warp: eight lanes of one sum.
//                           Each half-group runs its lane's ladder
//                           (curve.cuh pt_mul_bits: a doubling on every
//                           bit, a complete addition on every set bit);
//                           the warp then folds its eight sums by
//                           shuffles and writes one Jacobian partial.
//                           Grid: lane blocks × k sums, so the k sums of
//                           one call run side by side.
//   msm_final_kernel        one warp a sum: each half-group folds every
//                           eighth partial, the warp folds the eight,
//                           and a half-group converts the sum to affine
//                           (gg_affine: a Fermat inversion of the norm).
//
// The lanes of a warp have different bits, so the addition of a step runs
// wherever any lane of the warp has its bit set, and each lane keeps its
// own case (a lane whose bit is 0 adds infinity, which leaves it as it
// is); the doubling runs wherever any lane is finite. A masked lane, and
// a lane past n, computes as the warp's first lane does and contributes
// infinity, so the warp stays whole for every shuffle.
//
// Bound: integer multiply-adds (each ladder step is a doubling, 16 Fp
// products, and on a set bit a complete addition, 43); inputs are a few
// hundred bytes per lane. The ladder is one dependent chain per lane,
// so the time is the latency of the longest chain of a warp; a bucket of
// 512 lanes is 64 warps a sum, one a block, on as many SMs (the two sums
// of a wire bucket on 128). The affine
// result is unique, so the order of the fold does not change it and the
// output agrees word for word with the plain version
// (ops/msm.py:msm_plain).
//
// Layouts (int32 words of canonical Montgomery values):
//   pts  (k, n, 2, 2, 12)  affine x / y of each sum's lanes, c0 / c1
//   mask (n,)              nonzero: the lane is left out of every sum
//   bits (n, nbits)        0/1, MSB first
//   out  (k, 2*2*12 + 1)   affine x, y of each sum, then 1 iff it is
//                          infinity (x and y are zero then)
#include "fp_group.cuh"

// A block is one warp. Blocks of two warps, their sums folded in shared
// memory (half as many partials), measured 1.5-4% slower at every shape
// on an H100, with 154 registers against 128 (PERF.md, §6).
#define MSM_BLOCK 32
#define MSM_LANES (MSM_BLOCK / GT)   // lanes a block: one a half-group
#define MSM_PART_WORDS (6 * NW + 1)  // a Jacobian partial: x, y, z, inf

#if defined(__CUDACC__) || defined(GG_WARP_EMULATION)

// g2_group.cuh's layout: the addition's temporaries (0..15), then
enum : int {
  S_ACC = 16,    // the lane's accumulator (3 slots)
  S_BASE = 19,   // its point (3 slots)
  S_OTH = 22,    // a point to fold in (3 slots)
  S_DB = 25,     // an addition's doubling case (3 slots)
  S_FN = 28, S_FI = 29,   // an inversion's norm and its inverse
  MSM_SLOTS = 30,
  K_ONE = MSM_SLOTS       // the constant one (an operand only)
};

#define GG_BLOCK MSM_BLOCK
#define GG_SLOTS MSM_SLOTS
#define GG_DB S_DB
#define GG_NORM S_FN
#define GG_RECIP S_FI
#define GG_ONE K_ONE

// the MSM has no constant operand but one
FG_INL void gg_ld_const(F2g& r, int, const Half&) {
  fg_zero(r.c0);
  fg_zero(r.c1);
}

#include "g2_group.cuh"

FG_INL uint32_t msm_half_group() { return GG_TID / GT; }

// Point slots P := infinity, as curve.cuh pt_set_inf: (1, 1, 0)
FG_INL void msm_set_inf(int p) {
  gg_copy(p, K_ONE);
  gg_copy(p + 1, K_ONE);
  gg_zero(p + 2);
}

// Fold the warp's eight accumulators (S_ACC, flag ainf) into every
// half-group's: three levels of pairwise sums by gg_swap_add, so both
// half-groups of a pair compute the same sum (S_OTH the partner's point).
FG_INL uint32_t msm_warp_fold(uint32_t ainf) {
  const uint32_t hg = msm_half_group();
#pragma unroll 1
  for (int d = 1; d < MSM_LANES; d *= 2)
    ainf = gg_swap_add(S_ACC, S_OTH, ainf, (hg / (uint32_t)d) % 2u, GT * d,
                       32);
  return ainf;
}

// One block's lanes first .. first + MSM_LANES - 1 of a sum: each
// half-group's ladder, then the warp's fold into the partial PART
// (written by half-group 0).
FG_INL void msm_ladder_block(const uint32_t* pts, const int32_t* mask,
                             const int32_t* bits, int nbits, uint32_t* part,
                             int n, int first) {
  const uint32_t k = GG_TID % 32u % GT, hg = msm_half_group();
  gg_init();
  const int me = first + (int)hg;
  const uint32_t live = me < n && mask[me] == 0 ? 1u : 0u;
  const int src = live ? me : first;
  const uint32_t* pt = pts + (size_t)src * 4 * NW;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v)
      gg_word(S_BASE + c, v) = pt[c * 2 * NW + (v / GW) * NW + GW * k +
                                  v % GW];
  gg_copy(S_BASE + 2, K_ONE);
  msm_set_inf(S_ACC);
  uint32_t ainf = 1u;
  const int32_t* b = bits + (size_t)src * nbits;
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    const uint32_t bit = b[i] != 0 ? 1u : 0u;
    if (gg_warp_any(ainf ^ 1u)) gg_dbl(S_ACC, S_ACC);
    if (gg_warp_any(bit))
      ainf = gg_pt_add(S_ACC, S_ACC, ainf, S_BASE, bit ^ 1u);
  }
  ainf = msm_warp_fold(live ? ainf : 1u);
  if (hg != 0) return;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v)
      part[c * 2 * NW + (v / GW) * NW + GW * k + v % GW] =
          gg_word(S_ACC + c, v);
  if (k == 0) part[6 * NW] = ainf;
}

// One sum's nblocks partials -> its affine words and infinity flag in OUT
// (4 * NW + 1 words).
FG_INL void msm_final_block(const uint32_t* part, int nblocks,
                            uint32_t* out) {
  const uint32_t k = GG_TID % 32u % GT, hg = msm_half_group();
  gg_init();
  msm_set_inf(S_ACC);
  uint32_t ainf = 1u;
#pragma unroll 1
  for (int i0 = 0; i0 < nblocks; i0 += MSM_LANES) {
    const int i = i0 + (int)hg;
    uint32_t oinf = 1u;
    if (i < nblocks) {
      const uint32_t* q = part + (size_t)i * MSM_PART_WORDS;
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int v = 0; v < 2 * GW; ++v)
          gg_word(S_OTH + c, v) = q[c * 2 * NW + (v / GW) * NW + GW * k +
                                    v % GW];
      oinf = q[6 * NW];
    }
    ainf = gg_pt_add(S_ACC, S_ACC, ainf, S_OTH, oinf);
  }
  ainf = msm_warp_fold(ainf);
  gg_affine(S_OTH, S_OTH + 1, S_ACC, ainf);
  if (hg != 0) return;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int v = 0; v < 2 * GW; ++v)
      out[c * 2 * NW + (v / GW) * NW + GW * k + v % GW] =
          ainf ? 0u : gg_word(S_OTH + c, v);
  if (k == 0) out[4 * NW] = ainf;
}

#endif  // __CUDACC__ || GG_WARP_EMULATION

#if defined(__CUDACC__)

static int msm_blocks(int n) { return (n + MSM_LANES - 1) / MSM_LANES; }

// Block (x, y): lanes 8x .. 8x + 7 of sum y; its partial at x + nb·y
__global__ void __launch_bounds__(MSM_BLOCK)
msm_ladder_fold_kernel(const uint32_t* __restrict__ pts,
                       const int32_t* __restrict__ mask,
                       const int32_t* __restrict__ bits, int nbits,
                       uint32_t* __restrict__ partial, int n) {
  const int sum = blockIdx.y;
  msm_ladder_block(pts + (size_t)sum * n * 4 * NW, mask, bits, nbits,
                   partial + ((size_t)sum * gridDim.x + blockIdx.x) *
                                 MSM_PART_WORDS,
                   n, blockIdx.x * MSM_LANES);
}

// Block y: sum y's partials -> out[y]
__global__ void __launch_bounds__(MSM_BLOCK)
msm_final_kernel(const uint32_t* __restrict__ partial, int nblocks,
                 uint32_t* __restrict__ out) {
  const int sum = blockIdx.x;
  msm_final_block(partial + (size_t)sum * nblocks * MSM_PART_WORDS, nblocks,
                  out + (size_t)sum * (4 * NW + 1));
}

// int32 words of scratch the launch needs for k sums of n lanes
extern "C" int msm_scratch_words(int n, int k) {
  return k * msm_blocks(n) * MSM_PART_WORDS;
}

extern "C" int msm_launch(const void* consts, int n_words, const void* pts,
                          const void* mask, const void* bits, int nbits,
                          void* scratch, int scratch_words, void* out, int n,
                          int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || k < 1 || nbits < 1 || scratch_words < msm_scratch_words(n, k))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  const int nb = msm_blocks(n);
  msm_ladder_fold_kernel<<<dim3(nb, k), MSM_BLOCK, 0, s>>>(
      (const uint32_t*)pts, (const int32_t*)mask, (const int32_t*)bits, nbits,
      (uint32_t*)scratch, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  msm_final_kernel<<<k, MSM_BLOCK, 0, s>>>((const uint32_t*)scratch, nb,
                                           (uint32_t*)out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
