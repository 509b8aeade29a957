// Tiled f32 matmul with a noise slot after every K step, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/noisy_matmul/kernel.py matmul_pallas and
// matmul_pallas_rt (pallas_call at :87 and :132, body _mm_body :33):
// out = a @ b with 128x128 output tiles, a K loop of 128-wide steps, and one
// noise slot after each K step at step = i*131 + j*17 + kk (i: tile row,
// j: tile column), the vmem source being the raw f32 A tile. The slot
// geometry is the reference's at its region tile size (bm = bn = bk =
// 128), so nacc matches the JAX package for every mode.
//
// What bounds it on the H100: operations. n = 4096 is 2n^3 = 137.4 GFLOP,
// 0.28 ms at the 495 TFLOP/s TF32 dense peak; its 192 MiB of operands would
// take 0.06 ms at 3.35 TB/s.
//
// Design: keep the tensor cores fed, which only wgmma can do.
// * Products are wgmma m64n128k8 TF32 with f32 accumulators in registers:
//   one CTA per output tile, two consumer warpgroups of 64 rows each (64
//   accumulator registers a thread), both operands read by the tensor
//   cores straight from shared memory.
// * TF32 wgmma wants both operands K-major. A (M x K) is; B (K x N) is not,
//   so a first kernel writes B^T rounded to TF32 (cvt.rna, the rounding
//   mma.sync fragments get; 128 MiB of traffic at n = 4096). A stays raw
//   f32 in shared memory because it is the vmem noise source; the tensor
//   cores read its top 19 bits (TF32 truncation).
// * A third warpgroup is the producer: one thread keeps a ring of stages in
//   flight with TMA, each stage a 32-wide K slice of A and B^T (16 KiB
//   each, 128B-swizzled), completed on a `full` mbarrier and handed back
//   on an `empty` one. Ring depth: 6 stages (192 KiB) for none/fp/vmem, 4
//   (128 KiB) for mxu, whose staged 66 KiB noise operand takes the rest.
// * The slot of step kk runs after the step's last products are issued,
//   so its adds overlap the in-flight wgmma (the slack absorption reads).
//   In vmem mode the step's four A slices stay resident until the slot
//   has read them, through the swizzle; in the other modes a stage is
//   released as soon as its products are done.
// * The noise is emitted by the 256 consumer threads in noise_slots.cuh's
//   ownership layout; CTAs walk tiles in groups of 8 tile rows so a wave
//   shares A and B^T in L2. Partials: 1024 x 4 KiB = 4 MiB at n = 4096.
#include <chrono>

#include "hopper.cuh"
#include "noise_slots.cuh"

#define MM_TILE 128
#define MM_THREADS 384          // two consumer warpgroups and a producer
#define MM_SLICE 32             // K columns per ring stage
#define MM_SLICE_BYTES (MM_TILE * MM_SLICE * 4)   // 16 KiB: A or B^T
#define MM_STAGE_BYTES (2 * MM_SLICE_BYTES)
#define MM_GROUP 8              // tile rows per raster group
#define MM_NZ_BYTES (128 * REPRO_NZ_STRIDE * 4)

template <int MODE>
__host__ __device__ constexpr int mm_stages() { return MODE == MODE_MXU ? 4 : 6; }

// mirrored by kernels/noisy_matmul/kernel.py smem_bytes: ring, noise
// operand (mxu), full and empty barriers, and slack to align to 1024
template <int MODE>
__host__ __device__ constexpr int matmul_smem_bytes() {
  return mm_stages<MODE>() * MM_STAGE_BYTES + (MODE == MODE_MXU ? MM_NZ_BYTES : 0) +
         2 * mm_stages<MODE>() * 8 + 1024;
}

// b (K x N) -> bt (N x K), rounded to TF32
__global__ void transpose_tf32(const float* __restrict__ b, float* __restrict__ bt, int K, int N) {
  __shared__ float t[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8)
    t[i][threadIdx.x] = __ldg(b + (size_t)(k0 + i) * N + n0 + threadIdx.x);
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8)
    bt[(size_t)(n0 + i) * K + k0 + threadIdx.x] = __uint_as_float(to_tf32(t[threadIdx.x][i]));
}

// vmem slot over the step's four swizzled A slices: logical A[R, col]
template <int SK>
__device__ __forceinline__ void vmem_noise_a(float (&acc)[4], const uint8_t* ring, int g0, int step,
                                             int k, int tid, int depth) {
  const int col = own_col(tid);
  const volatile float* src = reinterpret_cast<const float*>(
      ring + ((g0 + (col >> 5)) % depth) * MM_STAGE_BYTES);
  repeat_k<SK>(k, [&](int j) {
    const int off = (step * 7 + j * 13) % (MM_TILE - 8);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc[r] = __fadd_rn(acc[r], src[swz(off + own_row(tid, r), col & 31)]);
  });
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int MODE, int SK>
__global__ void __launch_bounds__(MM_THREADS, 1)
matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tbt,
              const float* __restrict__ noise, float* __restrict__ out,
              float* __restrict__ partials, int N, int K, int k) {
  constexpr int D = mm_stages<MODE>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  float* Ns = reinterpret_cast<float*>(ring + D * MM_STAGE_BYTES);   // mxu only
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D * MM_STAGE_BYTES +
                                               (MODE == MODE_MXU ? MM_NZ_BYTES : 0));
  uint64_t* empty = full + D;
  const int tid = threadIdx.x, lane = tid & 31;

  // tile (ti, tj) of this CTA: groups of MM_GROUP tile rows, columns within
  const int nx = N / MM_TILE, ny = gridDim.x / nx;
  const int per_group = MM_GROUP * nx, first = (blockIdx.x / per_group) * MM_GROUP;
  const int rows = min(ny - first, MM_GROUP), in_group = blockIdx.x % per_group;
  const int ti = first + in_group % rows, tj = in_group / rows;
  const int nk = K / MM_TILE, nslices = nk * (MM_TILE / MM_SLICE);

  if (tid == 0) {
    for (int s = 0; s < D; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  if constexpr (MODE == MODE_MXU) {
    if (tid < REPRO_THREADS) stage_noise(noise, Ns, tid);
  }
  __syncthreads();

  if (tid >= REPRO_THREADS) {   // producer warpgroup: one thread issues TMA
    if (tid == REPRO_THREADS) {
      for (int g = 0; g < nslices; ++g) {
        const int s = g % D;
        if (g >= D) mbar_wait(&empty[s], ((g / D) - 1) & 1);
        mbar_expect_tx(&full[s], MM_STAGE_BYTES);
        tma_load_2d(ring + s * MM_STAGE_BYTES, &ta, &full[s], g * MM_SLICE, ti * MM_TILE);
        tma_load_2d(ring + s * MM_STAGE_BYTES + MM_SLICE_BYTES, &tbt, &full[s], g * MM_SLICE,
                    tj * MM_TILE);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
  const int wg = tid >> 7;
  float c[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) c[i] = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fc[4];
  if constexpr (MODE == MODE_FP) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fc[r] = __ldg(noise + own_row(tid, r) * 128 + own_col(tid));
  }

  for (int kk = 0; kk < nk; ++kk) {
    const int g0 = kk * (MM_TILE / MM_SLICE);
#pragma unroll
    for (int q = 0; q < MM_TILE / MM_SLICE; ++q) {
      const int g = g0 + q, s = g % D;
      mbar_wait(&full[s], (g / D) & 1);
      const uint8_t* st = ring + s * MM_STAGE_BYTES;
      const uint64_t da = desc_sw128(st + wg * 64 * HOP_ROW_BYTES);
      const uint64_t db = desc_sw128(st + MM_SLICE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < MM_SLICE / 8; ++ks) wgmma_m64n128k8_ss(c, da + 2 * ks, db + 2 * ks, 1);
      wgmma_commit();
      if constexpr (MODE != MODE_VMEM) {
        wgmma_wait<1>();   // the previous slice's products are done with it
        fence_regs(c);
        if (g > 0) release(&empty[(g - 1) % D], lane);
      }
    }

    // noise slot: after the step's products are issued, overlapping them
    const int step = ti * 131 + tj * 17 + kk;
    if constexpr (MODE == MODE_FP) fp_noise<SK>(acc, fc, k);
    else if constexpr (MODE == MODE_VMEM) vmem_noise_a<SK>(acc, ring, g0, step, k, tid, D);
    else if constexpr (MODE == MODE_MXU) mxu_noise_lean<SK>(acc, Ns, REPRO_NZ_STRIDE, k, tid);
    if constexpr (MODE == MODE_VMEM) {   // the slot has read the A slices
      wgmma_wait<0>();
      fence_regs(c);
#pragma unroll
      for (int q = 0; q < MM_TILE / MM_SLICE; ++q) release(&empty[(g0 + q) % D], lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(c);

  const int w = (tid & 127) >> 5, gr = lane >> 2, t = lane & 3;
  const size_t row = (size_t)ti * MM_TILE + wg * 64 + w * 16 + gr;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = tj * MM_TILE + j * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + row * N + col) = make_float2(c[4 * j], c[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * N + col) =
        make_float2(c[4 * j + 2], c[4 * j + 3]);
  }
  write_partial<MODE>(partials + ((size_t)ti * nx + tj) * REPRO_NACC, acc, tid);
}

// smem: the wrapper's mirror of matmul_smem_bytes<MODE>() (refused if it
// disagrees); bt: an N x K f32 scratch for B^T
template <int MODE, int SK>
static cudaError_t launch_matmul(const float* a, const float* b, const float* noise, float* out,
                                 float* bt, float* partials, float* scratch, float* nacc, int M,
                                 int N, int K, int smem, int k, cudaStream_t st) {
  if (smem != matmul_smem_bytes<MODE>() || M % MM_TILE || N % MM_TILE || K % MM_TILE)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(matmul_kernel<MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap ta, tbt;
  if ((e = make_map_f32(&ta, a, K, M, MM_TILE)) != cudaSuccess) return e;
  if ((e = make_map_f32(&tbt, bt, K, N, MM_TILE)) != cudaSuccess) return e;
  transpose_tf32<<<dim3(N / 32, K / 32), dim3(32, 8), 0, st>>>(b, bt, K, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n_cta = (N / MM_TILE) * (M / MM_TILE);
  matmul_kernel<MODE, SK><<<n_cta, MM_THREADS, smem, st>>>(ta, tbt, noise, out, partials, N, K, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_partials(partials, n_cta, scratch, nacc, st);
}

#ifdef REPRO_STATIC_K
extern "C" int repro_matmul_static(const float* a, const float* b, const float* noise, float* out,
                                   float* bt, float* partials, float* scratch, float* nacc, int M,
                                   int N, int K, int smem, void* stream) {
  return (int)launch_matmul<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      a, b, noise, out, bt, partials, scratch, nacc, M, N, K, smem, REPRO_STATIC_K,
      (cudaStream_t)stream);
}
#else
extern "C" int repro_matmul_rt(const float* a, const float* b, const float* noise, float* out,
                               float* bt, float* partials, float* scratch, float* nacc, int M,
                               int N, int K, int smem, int mode, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
#define MM_MODE(MD)                                                                          \
  return (int)launch_matmul<MD, -1>(a, b, noise, out, bt, partials, scratch, nacc, M, N, K, \
                                    smem, k, st)
  switch (mode) {
    case MODE_NONE: MM_MODE(MODE_NONE);
    case MODE_FP: MM_MODE(MODE_FP);
    case MODE_MXU: MM_MODE(MODE_MXU);
    case MODE_VMEM: MM_MODE(MODE_VMEM);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MM_MODE
}

// Host time of the two tensor-map encodes every launch makes (A and B^T),
// in microseconds per pair, the mean of `iters` pairs; -1 if one fails.
extern "C" double repro_matmul_map_us(const float* a, const float* bt, int M, int N, int K,
                                      int iters) {
  CUtensorMap ta, tbt;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (make_map_f32(&ta, a, K, M, MM_TILE) != cudaSuccess ||
        make_map_f32(&tbt, bt, K, N, MM_TILE) != cudaSuccess)
      return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
#endif
