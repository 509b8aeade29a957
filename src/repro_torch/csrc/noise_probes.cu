// Pure-noise probe kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/noise_probes/kernel.py probe_pallas and
// probe_pallas_rt (pallas_call at :42 and :60): n_steps grid steps, each
// emitting k noise patterns into the (8,128) f32 nacc, nothing else.
//
// What bounds it on the H100: the noise itself. Per CTA the work is k
// patterns of 1024 f32 adds (fp), 1024 shared-memory loads + adds (vmem) or
// 32 TF32 mma.sync (mxu); the only device-memory traffic is the 64 KiB noise
// operand (read through L2 by every CTA that stages it) and one 4 KiB
// partial per CTA. At k=0 the call is one launch: the partial writes and
// their reduction, whose chunk sums and final sum wait on 17 rounds of L2
// loads in sequence (~0.5 µs each at 1056 CTAs: most of the device time,
// PERF.md). The probe calibrates the per-pattern cost of each mode, so its
// t(0) is one launch and nothing more on the host.
//
// Design: one CTA per grid step (step = blockIdx.x; the main path runs 1056
// steps, 8 CTAs on each of the 132 SMs), 256 threads, each thread holding 4
// elements of the CTA's (8,128) partial in registers; the CTAs reduce the
// partials in their own epilogue (reduce_fused, noise_slots.cuh), so a call
// is one launch. vmem and mxu stage the noise operand in dynamic shared
// memory (66 KiB with padding, above the 48 KB default: the launch opts in
// once per device); fp keeps its addend in registers and touches no shared
// memory.
//
// Payload survival (fp): the static build at k=8 and at k=24 must differ by
// 16 patterns x 4 elements = 64 FADD in SASS; chip_smoke.py prints both
// counts from cuobjdump (PERF.md records them).
#include "noise_slots.cuh"

// none and fp: 8 CTAs an SM (at most 32 registers a thread), so the main
// path's 1056 steps run in one wave; vmem and mxu are held to 3 by their
// 66 KiB of shared memory
template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS,
                                  (MODE == MODE_NONE || MODE == MODE_FP) ? 8 : 1)
probe_kernel(const float* __restrict__ noise, float* partials, float* chunk_sums,
             unsigned* counters, float* nacc, int k) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int step = blockIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (MODE == MODE_FP) {
    float c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = __ldg(noise + own_row(tid, r) * 128 + own_col(tid));
    fp_noise<SK>(acc, c, k);
  } else if constexpr (MODE == MODE_VMEM || MODE == MODE_MXU) {
    stage_noise(noise, smem, tid);
    __syncthreads();
    if constexpr (MODE == MODE_VMEM)
      vmem_noise<SK>(acc, smem, REPRO_NZ_STRIDE, 128, 128, step, k, tid);
    else
      mxu_noise<SK>(acc, smem, REPRO_NZ_STRIDE, k, tid);
  }
  reduce_fused<MODE>(acc, partials, chunk_sums, counters, nacc, step, gridDim.x, tid);
}

// partials, chunk_sums, counters: the stream's workspace (noise_slots.cuh,
// reduce_fused), counters 0 on entry and on exit
template <int MODE, int SK>
static cudaError_t launch_probe(const float* noise, float* partials, float* chunk_sums,
                                unsigned* counters, float* nacc, int n_steps, int k,
                                cudaStream_t st) {
  static std::atomic<unsigned long long> smem_ready{0};
  const int smem =
      (MODE == MODE_VMEM || MODE == MODE_MXU) ? 128 * REPRO_NZ_STRIDE * (int)sizeof(float) : 0;
  cudaError_t e = allow_smem_once(probe_kernel<MODE, SK>, smem, smem_ready);
  if (e != cudaSuccess) return e;
  probe_kernel<MODE, SK><<<n_steps, REPRO_THREADS, smem, st>>>(noise, partials, chunk_sums,
                                                               counters, nacc, k);
  return cudaGetLastError();
}

#ifdef REPRO_STATIC_K
extern "C" int repro_probe_static(const float* noise, float* partials, float* chunk_sums,
                                  unsigned* counters, float* nacc, int n_steps, void* stream) {
  return (int)launch_probe<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      noise, partials, chunk_sums, counters, nacc, n_steps, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_probe_rt(const float* noise, float* partials, float* chunk_sums,
                              unsigned* counters, float* nacc, int n_steps, int mode, int k,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
  switch (mode) {
#define REPRO_PROBE(M) \
    return (int)launch_probe<M, -1>(noise, partials, chunk_sums, counters, nacc, n_steps, k, st)
    case MODE_NONE: REPRO_PROBE(MODE_NONE);
    case MODE_FP: REPRO_PROBE(MODE_FP);
    case MODE_MXU: REPRO_PROBE(MODE_MXU);
    case MODE_VMEM: REPRO_PROBE(MODE_VMEM);
#undef REPRO_PROBE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch floor: a kernel that does nothing, launched through the same
// host path as every kernel (chip_smoke.py times it).
static __global__ void empty_kernel() {}

extern "C" int repro_empty_rt(const float* unused, int mode, int k, void* stream) {
  (void)unused, (void)mode, (void)k;
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif
