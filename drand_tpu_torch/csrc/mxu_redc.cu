// Montgomery product chains on Hopper, two ways: all on the CUDA cores,
// and with REDC's two constant-operand products on the int8 tensor cores.
// Each lane runs a <- a·b·2^-384 mod p for `iters` dependent steps, in the
// port's canonical 12 x 32-bit Montgomery words (R = 2^384), so the chain
// computes a·b^iters in the ordinary domain.
//
// Replaces the JAX package's tools/proto_mxu.py: its Pallas call over
// _chain_kernel, run with the all-VPU bl.mont_mul and with mont_mul_mxu,
// which moved t_lo·N' and m·p onto the TPU's matrix unit as int8 products
// against constant Toeplitz matrices of 12-bit limbs. The question is the
// same on this card: can REDC's two products by constants run on the int8
// tensor cores?
//
// mont_chain_cuda_kernel: one thread per lane, fp.cuh's CIOS fp_mul.
// mont_chain_tc_kernel: a·b (144 32x32->64 multiply-adds) on the CUDA
//   cores; then m = (T mod R)·N' mod R and m·p as u8 x u8 -> s32 mma.sync
//   (m16n8k32). A 384-bit value is 48 bytes; the product by a constant c
//   is a Toeplitz matrix G[k][i] = c_(k-i) (bytes of c) times the byte
//   vector, and every column sum is at most 48·255² < 2^22, exact in s32.
//   The lanes are the GEMM's N (8 per mma), the constant matrices its A
//   (48 x 64 for N', 96 x 64 for p; the input bytes 48..63 are zero), the
//   bytes its K. The column sums go through shared memory to the thread of
//   their lane, which carries them (four columns a 64-bit word), adds T,
//   keeps the high half and subtracts p once: the result is canonical.
//
// What bounds them: the CUDA-core chain, integer multiply-adds (588 int32
// MADs per product, as every kernel of the port); the tensor-core chain,
// its 288 int32 MADs per product on the CUDA cores (the tensor-core work,
// 2·(48 + 96)·64 = 18,432 int8 operations per lane and product, is worth
// 0.6 of them at the dense int8 rate), plus the shared-memory round trips
// between the GEMMs and the carries, which are its own cost.
//
// Layouts: a, b, out (n, 12) int32 words; g_nprime (48, 64) and g_p
// (96, 64) uint8, row k = output byte column, column i = input byte.
#include "fp.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define CUDA_LANES_PER_BLOCK 128
#define TC_WARPS 4
#define TC_THREADS (TC_WARPS * 32)
#define NP_TILES 3               // 48 rows of G_N' in m-tiles of 16
#define P_TILES 6                // 96 rows of G_p
#define K_STEPS 2                // 64 input bytes in k-steps of 32
#define X_STRIDE 20              // words per lane of the byte staging (no
                                 // bank conflicts on the B fragments)
#define S_STRIDE 100             // words per lane of the column sums (16-byte
                                 // rows; conflict-free vector reads)

__global__ void __launch_bounds__(CUDA_LANES_PER_BLOCK)
mont_chain_cuda_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, int n, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fp x, y;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x.w[i] = a[lane * NW + i];
    y.w[i] = b[lane * NW + i];
  }
  for (int it = 0; it < iters; ++it) fp_mul(x, x, y);
#pragma unroll
  for (int i = 0; i < NW; ++i) out[lane * NW + i] = x.w[i];
}

__device__ __forceinline__ void mma_u8(int32_t* c, const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A fragments of a (rows x 64) byte matrix in fragment order:
// frag[(mt * K_STEPS + ks) * 32 + lane] = the lane's four A registers.
// reg0 = G[16mt + g][32ks + 4t ..], reg1 = row + 8, reg2 = column + 16,
// reg3 = both (g = lane / 4, t = lane % 4; byte j of a register is column
// 4t + j).
__device__ void fill_a_frags(uint4* frag, const uint8_t* G, int tiles) {
  const uint32_t* w = (const uint32_t*)G;   // 16 words a row
  for (int i = threadIdx.x; i < tiles * K_STEPS * 32; i += blockDim.x) {
    const int lane = i % 32, ks = (i / 32) % K_STEPS, mt = i / (32 * K_STEPS);
    const int r = 16 * mt + lane / 4, c = 8 * ks + lane % 4;
    frag[i] = make_uint4(w[r * 16 + c], w[(r + 8) * 16 + c],
                         w[r * 16 + c + 4], w[(r + 8) * 16 + c + 4]);
  }
}

// S (32 lanes x rows column sums) = G (rows x 64) · X (64 bytes x 32 lanes)
template <int TILES>
__device__ __forceinline__ void byte_gemm(uint32_t* S, const uint4* gf,
                                          const uint32_t* X, int lane) {
  const int g = lane / 4, t = lane % 4;
  uint32_t bf[4][K_STEPS][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int ks = 0; ks < K_STEPS; ++ks) {
      bf[nt][ks][0] = X[(8 * nt + g) * X_STRIDE + 8 * ks + t];
      bf[nt][ks][1] = X[(8 * nt + g) * X_STRIDE + 8 * ks + 4 + t];
    }
#pragma unroll
  for (int mt = 0; mt < TILES; ++mt) {
    const uint4 a0 = gf[(mt * K_STEPS + 0) * 32 + lane];
    const uint4 a1 = gf[(mt * K_STEPS + 1) * 32 + lane];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int32_t c[4] = {0, 0, 0, 0};
      mma_u8(c, a0, bf[nt][0][0], bf[nt][0][1]);
      mma_u8(c, a1, bf[nt][1][0], bf[nt][1][1]);
      const int l0 = 8 * nt + 2 * t, r0 = 16 * mt + g;
      S[l0 * S_STRIDE + r0] = (uint32_t)c[0];
      S[(l0 + 1) * S_STRIDE + r0] = (uint32_t)c[1];
      S[l0 * S_STRIDE + r0 + 8] = (uint32_t)c[2];
      S[(l0 + 1) * S_STRIDE + r0 + 8] = (uint32_t)c[3];
    }
  }
}

// Four byte columns (each < 2^22) as one 64-bit term of word j
__device__ __forceinline__ uint64_t column_word(const uint32_t* row, int j) {
  const uint4 v = reinterpret_cast<const uint4*>(row)[j];
  return (uint64_t)v.x + ((uint64_t)v.y << 8) + ((uint64_t)v.z << 16) +
         ((uint64_t)v.w << 24);
}

__global__ void __launch_bounds__(TC_THREADS)
mont_chain_tc_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     const uint8_t* __restrict__ g_nprime,
                     const uint8_t* __restrict__ g_p,
                     uint32_t* __restrict__ out, int n, int iters) {
  extern __shared__ uint4 smem[];
  uint4* gf_np = smem;                                  // NP_TILES x 2 x 32
  uint4* gf_p = gf_np + NP_TILES * K_STEPS * 32;        // P_TILES x 2 x 32
  uint32_t* xs = (uint32_t*)(gf_p + P_TILES * K_STEPS * 32);
  uint32_t* ss = xs + TC_WARPS * 32 * X_STRIDE;
  fill_a_frags(gf_np, g_nprime, NP_TILES);
  fill_a_frags(gf_p, g_p, P_TILES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* X = xs + warp * 32 * X_STRIDE;
  uint32_t* S = ss + warp * 32 * S_STRIDE;
  uint32_t* my_x = X + lane * X_STRIDE;
  const uint32_t* my_s = S + lane * S_STRIDE;
#pragma unroll
  for (int i = NW; i < X_STRIDE; ++i) my_x[i] = 0u;     // bytes 48..63
  __syncthreads();

  // lanes past n run on zeros (the warp's mma needs every thread)
  const int idx = blockIdx.x * TC_THREADS + threadIdx.x;
  const bool live = idx < n;
  uint32_t x[NW], y[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x[i] = live ? a[idx * NW + i] : 0u;
    y[i] = live ? b[idx * NW + i] : 0u;
  }
  for (int it = 0; it < iters; ++it) {
    // T = x·y on the CUDA cores (24 words)
    uint32_t t[2 * NW];
#pragma unroll
    for (int i = 0; i < 2 * NW; ++i) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        c += (uint64_t)x[j] * y[i] + t[i + j];
        t[i + j] = (uint32_t)c;
        c >>= 32;
      }
      t[i + NW] = (uint32_t)c;
    }
    // m = (T mod R)·N' mod R: the N' GEMM, then 12 words of carries
#pragma unroll
    for (int i = 0; i < NW; ++i) my_x[i] = t[i];
    __syncwarp();
    byte_gemm<NP_TILES>(S, gf_np, X, lane);
    __syncwarp();
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t w = column_word(my_s, j) + carry;
      my_x[j] = (uint32_t)w;
      carry = w >> 32;
    }
    __syncwarp();
    // u = (T + m·p) / R: the p GEMM, then 24 words of carries with T; the
    // low half is zero by construction, u < 2p
    byte_gemm<P_TILES>(S, gf_p, X, lane);
    __syncwarp();
    carry = 0;
    uint32_t u[NW];
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) {
      const uint64_t w = column_word(my_s, j) + t[j] + carry;
      if (j >= NW) u[j - NW] = (uint32_t)w;
      carry = w >> 32;
    }
    Fp r;
    fp_reduce_once(r, u);
#pragma unroll
    for (int i = 0; i < NW; ++i) x[i] = r.w[i];
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NW; ++i) out[idx * NW + i] = x[i];
  }
}

extern "C" int mont_chain_launch(const void* consts, int n_words, int use_tc,
                                 const void* a, const void* b,
                                 const void* g_nprime, const void* g_p,
                                 void* out, int n, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = load_consts(consts, n_words, s);
  if (e != cudaSuccess) return (int)e;
  if (!use_tc) {
    mont_chain_cuda_kernel<<<(n + CUDA_LANES_PER_BLOCK - 1) /
                                 CUDA_LANES_PER_BLOCK,
                             CUDA_LANES_PER_BLOCK, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(NP_TILES + P_TILES) * K_STEPS * 32 *
                          sizeof(uint4) +
                      (size_t)TC_WARPS * 32 * (X_STRIDE + S_STRIDE) *
                          sizeof(uint32_t);
  e = cudaFuncSetAttribute(mont_chain_tc_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  mont_chain_tc_kernel<<<(n + TC_THREADS - 1) / TC_THREADS, TC_THREADS, smem,
                         s>>>((const uint32_t*)a, (const uint32_t*)b,
                              (const uint8_t*)g_nprime, (const uint8_t*)g_p,
                              (uint32_t*)out, n, iters);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
