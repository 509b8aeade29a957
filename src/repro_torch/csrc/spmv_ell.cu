// ELL sparse matrix-vector product with a noise slot, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spmv_ell/kernel.py spmv_ell_pallas and
// spmv_ell_pallas_rt (pallas_call at :98 and :124, body _spmv_body :40):
// y[r] = sum_l vals[r,l] * x[cols[r,l]] over 128-row blocks, with fp / vmem
// noise fed off each vals block and step = the block index.
//
// What bounds it on the H100: device memory. At the main path's size
// (R = N = 2^21 rows, L = 16) the call must move vals 128 MiB + cols
// 128 MiB + x 8 MiB + y 8 MiB ~ 285 MB, ~85 us at 3.35 TB/s, against 67 M
// FMAs. With q = 0 the x gather is a band (rows r-8..r+7), so x streams and
// hits L1/L2; as q grows the gather becomes random over all of x (the
// paper's SPMXV knob) and each gathered element is an L2 access.
//
// Design (the bulk-copy ring, for L <= 112):
// * Each CTA walks a contiguous run of bpc 128-row blocks in order (step =
//   block index, as in the reference): ~512 CTAs, all resident at once.
// * One elected thread copies each block's vals and cols (2 x 512*L bytes,
//   contiguous) into shared memory with cp.async.bulk on an mbarrier, up to
//   3 blocks ahead (as many stages as fit), so the copies of the next
//   blocks run while the CTA gathers x for this one: the CTA keeps its
//   device-memory stream in flight with no registers and no load
//   instructions of its own. The TPU's BlockSpec pipeline does the same
//   into VMEM.
// * The copies carry an L2 evict-first policy: vals and cols (256 MiB at
//   the main size) are read once and should not push x (8 MiB, inside the
//   50 MB L2) out. x is gathered under an evict-last policy (createpolicy):
//   at q = 1 every gather is an L2 access. In this design the two policies
//   cut the device time by 5% at q = 0 and 2% at q = 1 (PERF.md).
// * Two threads per row read its halves from shared memory (16-byte
//   loads; L must be a multiple of 8) and gather x through L1/L2: staging
//   x would hide exactly the gather locality that q varies. The halves
//   combine with one shuffle; each half's FMA order is the register
//   path's, so y is the same bit for bit.
// * Noise: fp's addend is vals[blk*128 + 0..7, 0] broadcast across lanes,
//   read with __ldg after the block's product; vmem re-reads the block's
//   (128, w = min(L,128)) vals where the copy put them, as the TPU re-reads
//   its VMEM block. Each CTA's (8,128) partial is summed in the kernel's
//   own epilogue (reduce_fused, noise_slots.cuh): a call is one launch.
// * Rows wider than two stages allow take the register path below: the
//   same arithmetic from 16-byte __ldg loads, vmem staged from registers.
// * Tried and not kept (PERF.md): the register path with the
//   epilogue (40 registers, 6 CTAs an SM) lost to the ring at q = 0 and
//   q = 1; in it, the L2 policies cost 26% at q = 0 and L1::no_allocate
//   loads fetched every sector from L2 twice.
#include "hopper.cuh"
#include "noise_slots.cuh"

#define SPMV_STAGES_MAX 3
// the ring's dynamic shared memory at most: a block's opt-in less 1 KiB for
// the kernel's static shared memory (the epilogue's ticket)
#define SPMV_RING_SMEM (REPRO_SMEM_MAX - 1024)

// Ring stages for rows of width L: as many (vals, cols) blocks and their
// mbarriers as fit in SPMV_RING_SMEM, at most 3; 0 when fewer than 2 fit
// (the register path).
static inline int ring_stages(int L) {
  const int per_stage = 2 * 128 * L * (int)sizeof(float) + 8;
  const int fit = SPMV_RING_SMEM / per_stage;
  return fit < 2 ? 0 : (fit < SPMV_STAGES_MAX ? fit : SPMV_STAGES_MAX);
}

// L2 eviction policies (createpolicy, sm_80+)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// a gathered element of x: through L1, its L2 line under `pol`
__device__ __forceinline__ float ld_kept(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// one elected thread copies `bytes` (16-byte aligned) from device memory to
// shared memory, their L2 lines evicted first; they complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(l2_evict_first())
      : "memory");
}

template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
spmv_ring_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 const float* __restrict__ x, float* __restrict__ y, float* partials,
                 float* chunk_sums, unsigned* counters, float* nacc, int nb, int L, int bpc,
                 int stages, int k) {
  // stages x (vals block, cols block), then one mbarrier a stage
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const int rib = tid >> 1, half = tid & 1;        // row in block, which half of the row
  const int hl = L >> 1;
  const int w = L < 128 ? L : 128;
  const int blk_floats = 128 * L;
  const uint32_t blk_bytes = blk_floats * (uint32_t)sizeof(float);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * stages * blk_floats);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint64_t kept = l2_evict_last();
  const int b0 = blockIdx.x * bpc;
  const int n = min(nb, b0 + bpc) - b0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto fetch = [&](int i) {   // block b0 + i into stage i % stages
    const int s = i % stages;
    float* dst = smem + 2 * s * blk_floats;
    mbar_expect_tx(&bars[s], 2 * blk_bytes);
    bulk_load(dst, vals + (size_t)(b0 + i) * blk_floats, blk_bytes, &bars[s]);
    bulk_load(dst + blk_floats, cols + (size_t)(b0 + i) * blk_floats, blk_bytes, &bars[s]);
  };
  if (tid == 0)
    for (int i = 0; i < min(n, stages); ++i) fetch(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % stages, blk = b0 + i;
    mbar_wait(&bars[s], (i / stages) & 1);
    const float* sv = smem + 2 * s * blk_floats;
    const float4* v4 = reinterpret_cast<const float4*>(sv + rib * L + half * hl);
    const int4* c4 = reinterpret_cast<const int4*>(sv + blk_floats + rib * L + half * hl);
    float sum = 0.f;
    for (int q = 0; q < (hl >> 2); ++q) {
      const float4 v = v4[q];
      const int4 c = c4[q];
      sum = __fmaf_rn(v.x, ld_kept(x + c.x, kept), sum);
      sum = __fmaf_rn(v.y, ld_kept(x + c.y, kept), sum);
      sum = __fmaf_rn(v.z, ld_kept(x + c.z, kept), sum);
      sum = __fmaf_rn(v.w, ld_kept(x + c.w, kept), sum);
    }
    const float other = __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) y[(size_t)blk * 128 + rib] = __fadd_rn(sum, other);

    // noise slot, after the block's product
    if constexpr (MODE == MODE_FP) {
      float c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = __ldg(vals + ((size_t)blk * 128 + own_row(tid, r)) * L);
      fp_noise<SK>(acc, c, k);
    } else if constexpr (MODE == MODE_VMEM) {
      vmem_noise<SK>(acc, sv, L, 128, w, blk, k, tid);
    }
    __syncthreads();   // every thread is done with stage s: refill it
    if (tid == 0 && i + stages < n) fetch(i + stages);
  }
  reduce_fused<MODE>(acc, partials, chunk_sums, counters, nacc, blockIdx.x, gridDim.x, tid);
}

// The register path, for rows too wide for two ring stages (L > 112).
template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
            const float* __restrict__ x, float* __restrict__ y, float* partials,
            float* chunk_sums, unsigned* counters, float* nacc, int nb, int L, int bpc, int k) {
  extern __shared__ __align__(16) float smem[];   // vmem: (128, w) block, row stride w
  const int tid = threadIdx.x;
  const int rib = tid >> 1, half = tid & 1;        // row in block, which half of the row
  const int hl = L >> 1;
  const int w = L < 128 ? L : 128;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int b0 = blockIdx.x * bpc;
  const int b1 = min(nb, b0 + bpc);
  for (int blk = b0; blk < b1; ++blk) {
    const size_t row = (size_t)blk * 128 + rib;
    const float4* v4 = reinterpret_cast<const float4*>(vals + row * L + half * hl);
    const int4* c4 = reinterpret_cast<const int4*>(cols + row * L + half * hl);
    float s = 0.f;
    for (int q = 0; q < (hl >> 2); ++q) {
      const float4 v = __ldg(v4 + q);
      const int4 c = __ldg(c4 + q);
      s = __fmaf_rn(v.x, __ldg(x + c.x), s);
      s = __fmaf_rn(v.y, __ldg(x + c.y), s);
      s = __fmaf_rn(v.z, __ldg(x + c.z), s);
      s = __fmaf_rn(v.w, __ldg(x + c.w), s);
      if constexpr (MODE == MODE_VMEM) {
        const int l = half * hl + 4 * q;
        float* dst = smem + rib * w + l;
        if (l + 0 < w) dst[0] = v.x;
        if (l + 1 < w) dst[1] = v.y;
        if (l + 2 < w) dst[2] = v.z;
        if (l + 3 < w) dst[3] = v.w;
      }
    }
    const float other = __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) y[row] = __fadd_rn(s, other);

    // noise slot, after the block's product
    if constexpr (MODE == MODE_FP) {
      float c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = __ldg(vals + ((size_t)blk * 128 + own_row(tid, r)) * L);
      fp_noise<SK>(acc, c, k);
    } else if constexpr (MODE == MODE_VMEM) {
      __syncthreads();
      vmem_noise<SK>(acc, smem, w, 128, w, blk, k, tid);
      __syncthreads();   // the next block overwrites the staged vals
    }
  }
  reduce_fused<MODE>(acc, partials, chunk_sums, counters, nacc, blockIdx.x, gridDim.x, tid);
}

// partials, chunk_sums, counters: the stream's workspace (noise_slots.cuh,
// reduce_fused), counters 0 on entry and on exit
template <int MODE, int SK>
static cudaError_t launch_spmv(const float* vals, const int* cols, const float* x, float* y,
                               float* partials, float* chunk_sums, unsigned* counters,
                               float* nacc, int R, int L, int bpc, int k, cudaStream_t st) {
  static std::atomic<unsigned long long> ring_ready{0}, reg_ready{0};
  const int nb = R / 128;
  const int P = (nb + bpc - 1) / bpc;
  const int stages = ring_stages(L);
  cudaError_t e;
  if (stages) {   // opt in once to the most any L needs
    if ((e = allow_smem_once(spmv_ring_kernel<MODE, SK>, SPMV_RING_SMEM, ring_ready)) != cudaSuccess)
      return e;
    spmv_ring_kernel<MODE, SK><<<P, REPRO_THREADS, stages * (2 * 128 * L * (int)sizeof(float) + 8),
                                 st>>>(vals, cols, x, y, partials, chunk_sums, counters, nacc, nb,
                                       L, bpc, stages, k);
  } else {
    const int w = L < 128 ? L : 128;
    if ((e = allow_smem_once(spmv_kernel<MODE, SK>,
                             MODE == MODE_VMEM ? 128 * 128 * (int)sizeof(float) : 0, reg_ready)) !=
        cudaSuccess)
      return e;
    spmv_kernel<MODE, SK><<<P, REPRO_THREADS, MODE == MODE_VMEM ? 128 * w * (int)sizeof(float) : 0,
                            st>>>(vals, cols, x, y, partials, chunk_sums, counters, nacc, nb, L,
                                  bpc, k);
  }
  return cudaGetLastError();
}

#ifdef REPRO_STATIC_K
extern "C" int repro_spmv_static(const float* vals, const int* cols, const float* x, float* y,
                                 float* partials, float* chunk_sums, unsigned* counters,
                                 float* nacc, int R, int L, int bpc, void* stream) {
  return (int)launch_spmv<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      vals, cols, x, y, partials, chunk_sums, counters, nacc, R, L, bpc, REPRO_STATIC_K,
      (cudaStream_t)stream);
}
#else
extern "C" int repro_spmv_rt(const float* vals, const int* cols, const float* x, float* y,
                             float* partials, float* chunk_sums, unsigned* counters, float* nacc,
                             int R, int L, int bpc, int mode, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
  switch (mode) {
#define REPRO_SPMV(M)                                                                          \
    return (int)launch_spmv<M, -1>(vals, cols, x, y, partials, chunk_sums, counters, nacc, R, \
                                   L, bpc, k, st)
    case MODE_NONE: REPRO_SPMV(MODE_NONE);
    case MODE_FP: REPRO_SPMV(MODE_FP);
    case MODE_VMEM: REPRO_SPMV(MODE_VMEM);
#undef REPRO_SPMV
    default:
      return (int)cudaErrorInvalidValue;   // spmv has no noise operand, hence no mxu
  }
}
#endif
