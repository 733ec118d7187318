// Multi-scalar multiplication over G2 on Hopper: sum_i bits_i · P_i, the
// Lagrange recovery of a threshold signature (chain/beacon/chain.go:136).
//
// Replaces the JAX package's ops/pallas_msm.py:_msm_kernel (per-lane
// double-and-add ladders on the TPU's 128 vector lanes, a log2(B)-step
// fold by lane rotation, an in-kernel to-affine). The lane width of 128
// and the rotation fold were TPU artefacts. Here:
//
//   msm_ladder_fold_kernel  one thread per lane runs that lane's ladder
//                           (pt_mul_bits, curve.cuh); a masked lane
//                           contributes infinity without running it. The
//                           block then folds its lanes in shared memory
//                           (a log tree of complete additions) and
//                           writes one Jacobian partial per block.
//   msm_final_kernel        one block folds the block partials and
//                           converts the sum to affine (f2_inv, a Fermat
//                           ladder).
//
// A G2 Jacobian point is 288 bytes and a thread runs at up to 255
// registers, so one block cannot hold a 512-lane MSM: the fold is two
// launches. The wrapper (ops/msm.py) counts the pair as one MSM launch.
//
// Bound: integer multiply-adds (each ladder step is a doubling, 16 Fp
// products, and on a set bit a complete addition, 43); inputs are a few
// hundred bytes per lane. The ladder is one dependent chain per thread,
// so the time is the latency of the longest lane's chain, not the card's
// throughput: 32 lanes per block spread the lanes over as many SMs as
// there are blocks. The affine result is unique, so the order of the
// fold does not change it and the output agrees word for word with the
// plain version (ops/msm.py:msm_plain).
//
// Layouts (int32 words of canonical Montgomery values):
//   pts  (n, 2, 2, 12)  affine x / y, c0 / c1
//   mask (n,)           nonzero: the lane is left out
//   bits (n, nbits)     0/1, MSB first
//   out  (2*2*12 + 1)   affine x, y of the sum, then 1 iff it is infinity
//                       (x and y are zero then)
#include "curve.cuh"

#define MSM_BLOCK 32

typedef Jac<Fp2> G2J;

// One lane's ladder from its affine point (host-callable for checks)
FP_FN void msm_lane(G2J& acc, const uint32_t* pt, const int32_t* bits,
                    int nbits) {
  G2J base;
  load_f2(base.x, pt);
  load_f2(base.y, pt + 2 * NW);
  fe_one(base.z);
  base.inf = 0u;
  pt_mul_bits(acc, base, bits, nbits);
}

// Affine output words of a point (zeros at infinity)
FP_FN void msm_store_affine(uint32_t* out, const G2J& s) {
  Fp2 x, y;
  if (s.inf) {
    f2_zero(x);
    f2_zero(y);
  } else {
    pt_to_affine(x, y, s);
  }
  store_f2(out, x);
  store_f2(out + 2 * NW, y);
  out[4 * NW] = s.inf ? 1u : 0u;
}

#if defined(__CUDACC__)

__device__ void block_fold(G2J* sh, int tid, int width) {
  for (int s = width / 2; s > 0; s >>= 1) {
    if (tid < s) {
      G2J a = sh[tid];
      const G2J b = sh[tid + s];
      pt_add(a, a, b);
      sh[tid] = a;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MSM_BLOCK)
msm_ladder_fold_kernel(const uint32_t* __restrict__ pts,
                       const int32_t* __restrict__ mask,
                       const int32_t* __restrict__ bits, int nbits,
                       G2J* __restrict__ partial, int n) {
  __shared__ G2J sh[MSM_BLOCK];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * MSM_BLOCK + tid;
  G2J acc;
  pt_set_inf(acc);
  if (lane < n && !mask[lane])
    msm_lane(acc, pts + lane * 4 * NW, bits + (size_t)lane * nbits, nbits);
  sh[tid] = acc;
  __syncthreads();
  block_fold(sh, tid, MSM_BLOCK);
  if (tid == 0) partial[blockIdx.x] = sh[0];
}

__global__ void __launch_bounds__(MSM_BLOCK)
msm_final_kernel(const G2J* __restrict__ partial, int nblocks,
                 uint32_t* __restrict__ out) {
  __shared__ G2J sh[MSM_BLOCK];
  const int tid = threadIdx.x;
  G2J acc;
  pt_set_inf(acc);
  for (int i = tid; i < nblocks; i += MSM_BLOCK) {
    const G2J p = partial[i];
    pt_add(acc, acc, p);
  }
  sh[tid] = acc;
  __syncthreads();
  block_fold(sh, tid, MSM_BLOCK);
  if (tid == 0) msm_store_affine(out, sh[0]);
}

static int msm_blocks(int n) { return (n + MSM_BLOCK - 1) / MSM_BLOCK; }

// int32 words of scratch the launch needs for n lanes
extern "C" int msm_scratch_words(int n) {
  return msm_blocks(n) * (int)(sizeof(G2J) / sizeof(uint32_t));
}

extern "C" int msm_launch(const void* consts, int n_words, const void* pts,
                          const void* mask, const void* bits, int nbits,
                          void* scratch, int scratch_words, void* out, int n,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || nbits < 1 || scratch_words < msm_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  const int nb = msm_blocks(n);
  msm_ladder_fold_kernel<<<nb, MSM_BLOCK, 0, s>>>(
      (const uint32_t*)pts, (const int32_t*)mask, (const int32_t*)bits, nbits,
      (G2J*)scratch, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  msm_final_kernel<<<1, MSM_BLOCK, 0, s>>>((const G2J*)scratch, nb,
                                           (uint32_t*)out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
