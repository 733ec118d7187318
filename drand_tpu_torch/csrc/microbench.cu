// Throughput probes of the primitives the field arithmetic could be built
// from, on Hopper: dependent chains on the CUDA cores and on the tensor
// cores, each written in PTX so that the loop keeps the instruction it
// measures (nvcc may not fold or re-associate an asm statement).
//
// Replaces the JAX package's tools/microbench.py:_pallas1 (the Pallas
// calls over vpu_kernel and mxu_kernel), which measured the TPU's VPU and
// MXU the same way: one dependent fori_loop chain over a tile.
//
// CUDA-core chains, one thread per element (bf16: per pair of elements),
// x <- x*y + y for `iters` dependent iterations:
//   chain_i32_kernel   mad.lo.u32        (IMAD; wraps mod 2^32)
//   chain_f32_kernel   fma.rn.f32        (FFMA; one rounding per step)
//   chain_bf16_kernel  fma.rn.bf16x2     (HFMA2.BF16; one rounding per step)
//   chain_wide_kernel  mad.lo.cc.u32 + madc.hi.u32: (c, x) <- x*y + c, the
//                      32x32->64 multiply-add pair of fp.cuh's CIOS product
//                      (a multiply-with-carry chain; two int32 MADs a step)
// Tensor-core chains, acc <- (acc as the input type) @ a, a 128 x 128
// constant, `iters` dependent products, hand-written mma.sync:
//   mma_bf16_kernel    m16n8k16 bf16 x bf16 -> f32
//   mma_s8_kernel      m16n8k32 s8 x s8 -> s32 (acc wraps to s8 each step)
//   mma_tf32_kernel    m16n8k8 tf32 x tf32 -> f32 (the card's f32 path on
//                      the tensor cores; inputs rounded by cvt.rna.tf32)
//
// What bounds them: the unit's issue rate (IMAD, FFMA, HFMA2 lanes; the
// tensor cores' dense rate). Inputs and outputs are read and written once.
// Design of the tensor-core chains: a warp owns 16 rows of acc, and each
// row of the next acc depends only on the same row of the last one, so a
// warp's accumulator fragments become its next A fragments in registers
// (no shared memory, no block barrier inside the chain). Where the C
// fragment does not hold the columns the A fragment wants (s8, tf32), the
// K index is permuted and the constant B is stored with its rows permuted
// the same way, which leaves the product unchanged. B lives in shared
// memory in fragment order: one 8-byte load per lane per mma.
//
// Layouts: x, y, out (n,) of the chain's type (bf16: n even); the wide
// chain's carry (n,) uint32 starts at 0. a (128, 128) row-major [k][n];
// b, out (m, 128) row-major, m a multiple of 128.
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define CHAIN_BLOCK 256
#define MMA_DIM 128                 // the chain's square width
#define MMA_WARPS 8                 // 16 rows each: 128 rows a block
#define MMA_THREADS (MMA_WARPS * 32)
#define N_TILES (MMA_DIM / 8)       // n-tiles of 8 columns

// ---------------------------------------------------------------------------
// CUDA-core chains
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CHAIN_BLOCK)
chain_i32_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 uint32_t* __restrict__ o, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x[i];
  const uint32_t b = y[i];
#pragma unroll 16
  for (int k = 0; k < iters; ++k)
    asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(a) : "r"(b));
  o[i] = a;
}

__global__ void __launch_bounds__(CHAIN_BLOCK)
chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ o, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  const float b = y[i];
#pragma unroll 16
  for (int k = 0; k < iters; ++k)
    asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(a) : "f"(b));
  o[i] = a;
}

// one thread per pair of bf16 elements (a .b32 register of bf16x2)
__global__ void __launch_bounds__(CHAIN_BLOCK)
chain_bf16_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                  uint32_t* __restrict__ o, int n_pairs, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  uint32_t a = x[i];
  const uint32_t b = y[i];
#pragma unroll 16
  for (int k = 0; k < iters; ++k)
    asm volatile("fma.rn.bf16x2 %0, %0, %1, %1;" : "+r"(a) : "r"(b));
  o[i] = a;
}

// multiply-with-carry: x*y + c = c'·2^32 + x'
__global__ void __launch_bounds__(CHAIN_BLOCK)
chain_wide_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                  uint32_t* __restrict__ o, uint32_t* __restrict__ carry, int n,
                  int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x[i], c = 0u;
  const uint32_t b = y[i];
#pragma unroll 16
  for (int k = 0; k < iters; ++k)
    asm volatile(
        "{\n\t"
        ".reg .u32 lo;\n\t"
        "mad.lo.cc.u32 lo, %0, %2, %1;\n\t"
        "madc.hi.u32 %1, %0, %2, 0;\n\t"
        "mov.u32 %0, lo;\n\t"
        "}"
        : "+r"(a), "+r"(c)
        : "r"(b));
  o[i] = a;
  carry[i] = c;
}

// ---------------------------------------------------------------------------
// Tensor-core chains
// ---------------------------------------------------------------------------

// Fragment coordinates of a lane: g = lane / 4 (the row of C and A, the
// column of B), t = lane % 4. C of an m16n8 tile: c0, c1 at (g, 2t, 2t+1),
// c2, c3 at (g+8, 2t, 2t+1).

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(p));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a,
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// B fragments in shared memory, fragment order: frag[(ks * N_TILES + nt) *
// 32 + lane] holds the lane's two B registers of k-step ks, n-tile nt.

// bf16, m16n8k16: reg0 = B[16ks + 2t, +1][n], reg1 = B[16ks + 2t + 8, +9][n]
__device__ void fill_b_bf16(uint2* frag, const __nv_bfloat16* a) {
  const int total = (MMA_DIM / 16) * N_TILES * 32;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int lane = i % 32, nt = (i / 32) % N_TILES, ks = i / (32 * N_TILES);
    const int g = lane / 4, t = lane % 4, n = nt * 8 + g, k = ks * 16 + 2 * t;
    uint2 r;
    r.x = bf16_bits(a + k * MMA_DIM + n) |
          (bf16_bits(a + (k + 1) * MMA_DIM + n) << 16);
    r.y = bf16_bits(a + (k + 8) * MMA_DIM + n) |
          (bf16_bits(a + (k + 9) * MMA_DIM + n) << 16);
    frag[i] = r;
  }
}

// s8, m16n8k32: the A register k-slots 4t..4t+3 hold the C columns
// {2t, 2t+1, 8+2t, 9+2t} of the 32-column block, slots 16+4t..16+4t+3 hold
// {16+2t, 17+2t, 24+2t, 25+2t}; B's rows follow the same order.
__device__ void fill_b_s8(uint2* frag, const int8_t* a) {
  const int total = (MMA_DIM / 32) * N_TILES * 32;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int lane = i % 32, nt = (i / 32) % N_TILES, ks = i / (32 * N_TILES);
    const int g = lane / 4, t = lane % 4, n = nt * 8 + g;
    const int rows[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (uint32_t)(uint8_t)a[(ks * 32 + rows[j]) * MMA_DIM + n] << (8 * j);
      hi |= (uint32_t)(uint8_t)a[(ks * 32 + 16 + rows[j]) * MMA_DIM + n]
            << (8 * j);
    }
    frag[i] = make_uint2(lo, hi);
  }
}

// tf32, m16n8k8: A k-slot t holds C column 2t, slot t+4 column 2t+1; so
// B's reg0 = B[8ks + 2t][n], reg1 = B[8ks + 2t + 1][n]
__device__ void fill_b_tf32(uint2* frag, const float* a) {
  const int total = (MMA_DIM / 8) * N_TILES * 32;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int lane = i % 32, nt = (i / 32) % N_TILES, ks = i / (32 * N_TILES);
    const int g = lane / 4, t = lane % 4, n = nt * 8 + g, k = ks * 8 + 2 * t;
    frag[i] = make_uint2(to_tf32(a[k * MMA_DIM + n]),
                         to_tf32(a[(k + 1) * MMA_DIM + n]));
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
mma_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, float* __restrict__ o,
                int iters) {
  extern __shared__ uint2 frag[];
  fill_b_bf16(frag, a);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * MMA_DIM + warp * 16 + g;
  float acc[N_TILES][4];
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    acc[nt][0] = __bfloat162float(b[row * MMA_DIM + col]);
    acc[nt][1] = __bfloat162float(b[row * MMA_DIM + col + 1]);
    acc[nt][2] = __bfloat162float(b[(row + 8) * MMA_DIM + col]);
    acc[nt][3] = __bfloat162float(b[(row + 8) * MMA_DIM + col + 1]);
  }
  const uint2* my = frag + lane;
  for (int it = 0; it < iters; ++it) {
    uint32_t af[MMA_DIM / 16][4];
#pragma unroll
    for (int ks = 0; ks < MMA_DIM / 16; ++ks) {
      af[ks][0] = pack_bf16(acc[2 * ks][0], acc[2 * ks][1]);
      af[ks][1] = pack_bf16(acc[2 * ks][2], acc[2 * ks][3]);
      af[ks][2] = pack_bf16(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
      af[ks][3] = pack_bf16(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
    }
#pragma unroll
    for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MMA_DIM / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < N_TILES; ++nt)
        mma_bf16(acc[nt], af[ks], my[(ks * N_TILES + nt) * 32]);
  }
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    o[row * MMA_DIM + col] = acc[nt][0];
    o[row * MMA_DIM + col + 1] = acc[nt][1];
    o[(row + 8) * MMA_DIM + col] = acc[nt][2];
    o[(row + 8) * MMA_DIM + col + 1] = acc[nt][3];
  }
}

__device__ __forceinline__ uint32_t pack_s8(int32_t a, int32_t b, int32_t c,
                                            int32_t d) {
  return ((uint32_t)a & 0xFFu) | (((uint32_t)b & 0xFFu) << 8) |
         (((uint32_t)c & 0xFFu) << 16) | ((uint32_t)d << 24);
}

__global__ void __launch_bounds__(MMA_THREADS)
mma_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
              int32_t* __restrict__ o, int iters) {
  extern __shared__ uint2 frag[];
  fill_b_s8(frag, a);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * MMA_DIM + warp * 16 + g;
  int32_t acc[N_TILES][4];
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    acc[nt][0] = b[row * MMA_DIM + col];
    acc[nt][1] = b[row * MMA_DIM + col + 1];
    acc[nt][2] = b[(row + 8) * MMA_DIM + col];
    acc[nt][3] = b[(row + 8) * MMA_DIM + col + 1];
  }
  const uint2* my = frag + lane;
  for (int it = 0; it < iters; ++it) {
    uint32_t af[MMA_DIM / 32][4];
#pragma unroll
    for (int ks = 0; ks < MMA_DIM / 32; ++ks) {
      const int j = 4 * ks;   // n-tiles j .. j+3 are the block's columns
      af[ks][0] = pack_s8(acc[j][0], acc[j][1], acc[j + 1][0], acc[j + 1][1]);
      af[ks][1] = pack_s8(acc[j][2], acc[j][3], acc[j + 1][2], acc[j + 1][3]);
      af[ks][2] = pack_s8(acc[j + 2][0], acc[j + 2][1], acc[j + 3][0],
                          acc[j + 3][1]);
      af[ks][3] = pack_s8(acc[j + 2][2], acc[j + 2][3], acc[j + 3][2],
                          acc[j + 3][3]);
    }
#pragma unroll
    for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
#pragma unroll
    for (int ks = 0; ks < MMA_DIM / 32; ++ks)
#pragma unroll
      for (int nt = 0; nt < N_TILES; ++nt)
        mma_s8(acc[nt], af[ks], my[(ks * N_TILES + nt) * 32]);
  }
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    o[row * MMA_DIM + col] = acc[nt][0];
    o[row * MMA_DIM + col + 1] = acc[nt][1];
    o[(row + 8) * MMA_DIM + col] = acc[nt][2];
    o[(row + 8) * MMA_DIM + col + 1] = acc[nt][3];
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
mma_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ o, int iters) {
  extern __shared__ uint2 frag[];
  fill_b_tf32(frag, a);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * MMA_DIM + warp * 16 + g;
  float acc[N_TILES][4];
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    acc[nt][0] = b[row * MMA_DIM + col];
    acc[nt][1] = b[row * MMA_DIM + col + 1];
    acc[nt][2] = b[(row + 8) * MMA_DIM + col];
    acc[nt][3] = b[(row + 8) * MMA_DIM + col + 1];
  }
  const uint2* my = frag + lane;
  for (int it = 0; it < iters; ++it) {
    // k-step ks reads the old n-tile ks: a0 = (g, 2t), a1 = (g+8, 2t),
    // a2 = (g, 2t+1), a3 = (g+8, 2t+1)
    uint32_t af[N_TILES][4];
#pragma unroll
    for (int ks = 0; ks < N_TILES; ++ks) {
      af[ks][0] = to_tf32(acc[ks][0]);
      af[ks][1] = to_tf32(acc[ks][2]);
      af[ks][2] = to_tf32(acc[ks][1]);
      af[ks][3] = to_tf32(acc[ks][3]);
    }
#pragma unroll
    for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N_TILES; ++ks)
#pragma unroll
      for (int nt = 0; nt < N_TILES; ++nt)
        mma_tf32(acc[nt], af[ks], my[(ks * N_TILES + nt) * 32]);
  }
#pragma unroll
  for (int nt = 0; nt < N_TILES; ++nt) {
    const int col = nt * 8 + 2 * t;
    o[row * MMA_DIM + col] = acc[nt][0];
    o[row * MMA_DIM + col + 1] = acc[nt][1];
    o[(row + 8) * MMA_DIM + col] = acc[nt][2];
    o[(row + 8) * MMA_DIM + col + 1] = acc[nt][3];
  }
}

// ---------------------------------------------------------------------------
// C entry points (return cudaGetLastError())
// ---------------------------------------------------------------------------

// kind: 0 int32, 1 f32, 2 bf16 (n elements, even), 3 wide (carry output)
extern "C" int vpu_chain_launch(int kind, const void* x, const void* y,
                                void* out, void* carry, int n, int iters,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = kind == 2 ? n / 2 : n;
  const dim3 grid((threads + CHAIN_BLOCK - 1) / CHAIN_BLOCK);
  switch (kind) {
    case 0:
      chain_i32_kernel<<<grid, CHAIN_BLOCK, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, iters);
      break;
    case 1:
      chain_f32_kernel<<<grid, CHAIN_BLOCK, 0, s>>>(
          (const float*)x, (const float*)y, (float*)out, n, iters);
      break;
    case 2:
      if (n % 2) return (int)cudaErrorInvalidValue;
      chain_bf16_kernel<<<grid, CHAIN_BLOCK, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, threads,
          iters);
      break;
    case 3:
      chain_wide_kernel<<<grid, CHAIN_BLOCK, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out,
          (uint32_t*)carry, n, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// kind: 0 bf16 -> f32, 1 s8 -> s32, 2 tf32 (f32 in and out); m rows, a
// multiple of 128
extern "C" int mma_chain_launch(int kind, const void* a, const void* b,
                                void* out, int m, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m % MMA_DIM) return (int)cudaErrorInvalidValue;
  const dim3 grid(m / MMA_DIM);
  const int ksteps[3] = {MMA_DIM / 16, MMA_DIM / 32, MMA_DIM / 8};
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ksteps[kind] * N_TILES * 32 * sizeof(uint2);
  cudaError_t e = cudaSuccess;
  switch (kind) {
    case 0:
      e = cudaFuncSetAttribute(mma_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      mma_bf16_kernel<<<grid, MMA_THREADS, smem, s>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out,
          iters);
      break;
    case 1:
      e = cudaFuncSetAttribute(mma_s8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      mma_s8_kernel<<<grid, MMA_THREADS, smem, s>>>(
          (const int8_t*)a, (const int8_t*)b, (int32_t*)out, iters);
      break;
    default:
      e = cudaFuncSetAttribute(mma_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      mma_tf32_kernel<<<grid, MMA_THREADS, smem, s>>>(
          (const float*)a, (const float*)b, (float*)out, iters);
      break;
  }
  return (int)cudaGetLastError();
}
