// Tiled f32 matmul with a noise slot after every K step, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/noisy_matmul/kernel.py matmul_pallas and
// matmul_pallas_rt (pallas_call at :87 and :132, body _mm_body :33):
// out = a @ b with 128x128 output tiles, a K loop of 128-wide steps, and one
// noise slot after each K step at step = i*131 + j*17 + kk (i: tile row,
// j: tile column), the vmem source being the A tile. The slot geometry is
// the reference's at its region tile size (bm = bn = bk = 128), so nacc
// matches the JAX package for every mode.
//
// What bounds it on the H100: operations. n = 4096 is 2n^3 = 137.4 GFLOP,
// 0.28 ms at the 495 TFLOP/s TF32 dense peak; its 192 MiB of operands would
// take 0.06 ms at 3.35 TB/s.
//
// Design (simple first; TMA, wgmma and multi-stage pipelines come later):
// * One CTA per output tile, 256 threads = 8 warps as a 2x4 grid of 64x32
//   warp tiles; each warp issues mma.sync m16n8k8 TF32 (f32 accumulate,
//   4x4 fragments = 64 accumulator registers per thread). TF32 is the fair
//   counterpart of the TPU, whose f32 dot at default precision also runs
//   reduced-precision MXU passes.
// * One stage: the A and B tiles (f32, 64 KiB each) are copied to dynamic
//   shared memory with 16-byte loads, rows padded to 132 / 136 floats so
//   the fragment reads are free of bank conflicts (134 KiB in all; the mxu
//   mode adds the 66 KiB noise operand, 200 KiB, under the 227 KB limit).
//   A stays raw f32 in shared memory — it is the vmem noise source — and is
//   rounded to TF32 at fragment load.
// * The grid has (N/128)*(M/128) CTAs; their partials are 1024 x 4 KiB =
//   4 MiB at n = 4096, against 192 MiB of operands (2%) and 137 GFLOP.
#include "noise_slots.cuh"

#define MM_TILE 128
#define MM_AS 132   // A tile row stride (floats)
#define MM_BS 136   // B tile row stride (floats)

template <int MODE>
constexpr int matmul_smem_bytes() {
  return (MM_TILE * MM_AS + MM_TILE * MM_BS + (MODE == MODE_MXU ? 128 * REPRO_NZ_STRIDE : 0)) *
         (int)sizeof(float);
}

template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ noise, float* __restrict__ out,
              float* __restrict__ partials, int N, int K, int k) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                       // 128 x MM_AS
  float* Bs = As + MM_TILE * MM_AS;       // 128 x MM_BS
  float* Ns = Bs + MM_TILE * MM_BS;       // mxu only: 128 x REPRO_NZ_STRIDE
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int tj = blockIdx.x, ti = blockIdx.y;
  const int nk = K / MM_TILE;

  float c[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fc[4];
  if constexpr (MODE == MODE_FP) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fc[r] = __ldg(noise + own_row(tid, r) * 128 + own_col(tid));
  }
  if constexpr (MODE == MODE_MXU) stage_noise(noise, Ns, tid);   // synced below

  for (int kk = 0; kk < nk; ++kk) {
    for (int i = tid; i < MM_TILE * 32; i += REPRO_THREADS) {
      const int r = i >> 5, c4 = i & 31;
      const float4 va = __ldg(reinterpret_cast<const float4*>(
          a + (size_t)(ti * MM_TILE + r) * K + kk * MM_TILE + c4 * 4));
      const float4 vb = __ldg(reinterpret_cast<const float4*>(
          b + (size_t)(kk * MM_TILE + r) * N + tj * MM_TILE + c4 * 4));
      *reinterpret_cast<float4*>(As + r * MM_AS + c4 * 4) = va;
      *reinterpret_cast<float4*>(Bs + r * MM_BS + c4 * 4) = vb;
    }
    __syncthreads();
#pragma unroll 2
    for (int ks = 0; ks < 16; ++ks) {
      const int kc = ks * 8;
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ar = As + (wm * 64 + mt * 16 + g) * MM_AS + kc + t;
        af[mt][0] = to_tf32(ar[0]);
        af[mt][1] = to_tf32(ar[8 * MM_AS]);
        af[mt][2] = to_tf32(ar[4]);
        af[mt][3] = to_tf32(ar[8 * MM_AS + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* br = Bs + (kc + t) * MM_BS + wn * 32 + nt * 8 + g;
        bf[nt][0] = to_tf32(br[0]);
        bf[nt][1] = to_tf32(br[4 * MM_BS]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(c[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], bf[nt][0], bf[nt][1]);
    }

    // noise slot: after the tile FMA, before the next tile overwrites A
    const int step = ti * 131 + tj * 17 + kk;
    if constexpr (MODE == MODE_FP) fp_noise<SK>(acc, fc, k);
    else if constexpr (MODE == MODE_VMEM) vmem_noise<SK>(acc, As, MM_AS, MM_TILE, MM_TILE, step, k, tid);
    else if constexpr (MODE == MODE_MXU) mxu_noise<SK>(acc, Ns, REPRO_NZ_STRIDE, k, tid);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const size_t row = (size_t)ti * MM_TILE + wm * 64 + mt * 16 + g;
      const int col = tj * MM_TILE + wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + row * N + col) = make_float2(c[mt][nt][0], c[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * N + col) = make_float2(c[mt][nt][2], c[mt][nt][3]);
    }
  write_partial<MODE>(partials + ((size_t)ti * gridDim.x + tj) * REPRO_NACC, acc, tid);
}

template <int MODE, int SK>
static cudaError_t launch_matmul(const float* a, const float* b, const float* noise, float* out,
                                 float* partials, float* scratch, float* nacc, int M, int N, int K,
                                 int k, cudaStream_t st) {
  const int smem = matmul_smem_bytes<MODE>();
  cudaError_t e = allow_smem(matmul_kernel<MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / MM_TILE, M / MM_TILE);
  matmul_kernel<MODE, SK><<<grid, REPRO_THREADS, smem, st>>>(a, b, noise, out, partials, N, K, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_partials(partials, (int)(grid.x * grid.y), scratch, nacc, st);
}

#ifdef REPRO_STATIC_K
extern "C" int repro_matmul_static(const float* a, const float* b, const float* noise, float* out,
                                   float* partials, float* scratch, float* nacc, int M, int N,
                                   int K, void* stream) {
  return (int)launch_matmul<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      a, b, noise, out, partials, scratch, nacc, M, N, K, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_matmul_rt(const float* a, const float* b, const float* noise, float* out,
                               float* partials, float* scratch, float* nacc, int M, int N, int K,
                               int mode, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
  switch (mode) {
    case MODE_NONE:
      return (int)launch_matmul<MODE_NONE, -1>(a, b, noise, out, partials, scratch, nacc, M, N, K, k, st);
    case MODE_FP:
      return (int)launch_matmul<MODE_FP, -1>(a, b, noise, out, partials, scratch, nacc, M, N, K, k, st);
    case MODE_MXU:
      return (int)launch_matmul<MODE_MXU, -1>(a, b, noise, out, partials, scratch, nacc, M, N, K, k, st);
    case MODE_VMEM:
      return (int)launch_matmul<MODE_VMEM, -1>(a, b, noise, out, partials, scratch, nacc, M, N, K, k, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
