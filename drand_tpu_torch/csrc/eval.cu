// Horner evaluation of G1 commitment polynomials on Hopper: per lane,
// acc = C_{t-1}; repeat acc = [m]·acc + C_k (k = t-2 .. 0), m = idx + 1.
// It computes the share public keys of a threshold group (one polynomial,
// an index per lane: BatchedEngine.eval_poly_indices) and the DKG deal
// check (a polynomial per lane, one index: BatchedEngine.eval_commits).
//
// Replaces the JAX package's ops/pallas_eval.py:_eval_kernel (horner_bl,
// the dealers on the TPU's 128 vector lanes, the index bits shared by
// all lanes in SMEM at a fixed width of 10). Here the bits are per lane
// and the ladder's width is the width of the bits it is given, so the
// engine's 11-bit indices (up to 2046) are evaluated in full.
//
//   eval_horner_kernel  one thread per lane: the Horner steps, each a
//                       double-and-add ladder over the lane's bits
//                       (pt_mul_bits, curve.cuh) and a complete addition
//                       of the next commitment. With `affine` set, a
//                       finite result is normalised in the kernel to
//                       Z = 1 (an Fp Fermat inversion, ~4% of a t = 65
//                       lane), so that the fused threshold round feeds
//                       the keys to the pairing kernels without a trip
//                       to the host; without it the host converts a
//                       whole bucket with one batch inversion.
//
// Bound: integer multiply-adds (a G1 doubling is 7 Fp products, a
// complete addition 16); a lane reads t commitments of 96 bytes. Each
// lane is one dependent chain, so the time is one lane's latency; 32
// lanes per block spread a bucket over as many SMs as there are blocks.
//
// Layouts (int32 words of canonical Montgomery values):
//   commits (t, n, 2, 12)  affine x / y of commitment k of lane j
//   bits    (n, nbits)     0/1, MSB first, the bits of idx + 1
//   xyz     (n, 3, 12)     Jacobian X, Y, Z of the result
//   inf     (n,)           1 iff the result is infinity
#include "curve.cuh"

#define EVAL_BLOCK 32

typedef Jac<Fp> G1J;

// One lane's Horner (host-callable for checks)
FP_FN void horner_lane(G1J& acc, const uint32_t* commits, int t, int n,
                       int lane, const int32_t* bits, int nbits, int affine) {
  G1J c;
  fe_one(c.z);
  c.inf = 0u;
  const uint32_t* top = commits + ((size_t)(t - 1) * n + lane) * 2 * NW;
  load_fp(acc.x, top);
  load_fp(acc.y, top + NW);
  fe_one(acc.z);
  acc.inf = 0u;
  for (int k = t - 2; k >= 0; --k) {
    pt_mul_bits(acc, acc, bits, nbits);
    const uint32_t* ck = commits + ((size_t)k * n + lane) * 2 * NW;
    load_fp(c.x, ck);
    load_fp(c.y, ck + NW);
    pt_add(acc, acc, c);
  }
  if (affine && !acc.inf) {
    Fp x, y;
    pt_to_affine(x, y, acc);
    acc.x = x;
    acc.y = y;
    fe_one(acc.z);
  }
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(EVAL_BLOCK)
eval_horner_kernel(const uint32_t* __restrict__ commits, int t,
                   const int32_t* __restrict__ bits, int nbits, int affine,
                   uint32_t* __restrict__ xyz, int32_t* __restrict__ inf,
                   int n) {
  const int lane = blockIdx.x * EVAL_BLOCK + threadIdx.x;
  if (lane >= n) return;
  G1J acc;
  horner_lane(acc, commits, t, n, lane, bits + (size_t)lane * nbits, nbits,
              affine);
  uint32_t* o = xyz + (size_t)lane * 3 * NW;
  store_fp(o, acc.x);
  store_fp(o + NW, acc.y);
  store_fp(o + 2 * NW, acc.z);
  inf[lane] = acc.inf ? 1 : 0;
}

extern "C" int eval_horner_launch(const void* consts, int n_words,
                                  const void* commits, int t,
                                  const void* bits, int nbits, int affine,
                                  void* xyz, void* inf, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || t < 1 || nbits < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  eval_horner_kernel<<<(n + EVAL_BLOCK - 1) / EVAL_BLOCK, EVAL_BLOCK, 0, s>>>(
      (const uint32_t*)commits, t, (const int32_t*)bits, nbits, affine,
      (uint32_t*)xyz, (int32_t*)inf, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
