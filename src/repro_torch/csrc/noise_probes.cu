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
// partial per CTA. At k=0 the call is a launch plus the partial write and
// reduction: t(0) is set by launch overhead (~µs), the concession the
// reference makes with dispatch.
//
// Design: one CTA per grid step (step = blockIdx.x; the main path runs 1056
// steps, 8 CTAs on each of the 132 SMs), 256 threads, each thread holding 4
// elements of the CTA's (8,128) partial in registers; nacc_reduce sums the
// partials (noise_slots.cuh). vmem and mxu stage the noise operand in
// dynamic shared memory (66 KiB with padding, above the 48 KB default, so
// the launch opts in with cudaFuncSetAttribute); fp keeps its addend in
// registers and touches no shared memory.
//
// Payload survival (fp): the static build at k=8 and at k=24 must differ by
// 16 patterns x 4 elements = 64 FADD in SASS; chip_smoke.py prints both
// counts from cuobjdump (PERF.md records them).
#include "noise_slots.cuh"

template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
probe_kernel(const float* __restrict__ noise, float* __restrict__ partials, int k) {
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
  write_partial<MODE>(partials + (size_t)step * REPRO_NACC, acc, tid);
}

template <int MODE, int SK>
static cudaError_t launch_probe(const float* noise, float* partials, float* scratch, float* nacc,
                                int n_steps, int k, cudaStream_t st) {
  const int smem =
      (MODE == MODE_VMEM || MODE == MODE_MXU) ? 128 * REPRO_NZ_STRIDE * (int)sizeof(float) : 0;
  cudaError_t e = allow_smem(probe_kernel<MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  probe_kernel<MODE, SK><<<n_steps, REPRO_THREADS, smem, st>>>(noise, partials, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_partials(partials, n_steps, scratch, nacc, st);
}

#ifdef REPRO_STATIC_K
extern "C" int repro_probe_static(const float* noise, float* partials, float* scratch, float* nacc,
                                  int n_steps, void* stream) {
  return (int)launch_probe<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      noise, partials, scratch, nacc, n_steps, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_probe_rt(const float* noise, float* partials, float* scratch, float* nacc,
                              int n_steps, int mode, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
  switch (mode) {
    case MODE_NONE: return (int)launch_probe<MODE_NONE, -1>(noise, partials, scratch, nacc, n_steps, k, st);
    case MODE_FP: return (int)launch_probe<MODE_FP, -1>(noise, partials, scratch, nacc, n_steps, k, st);
    case MODE_MXU: return (int)launch_probe<MODE_MXU, -1>(noise, partials, scratch, nacc, n_steps, k, st);
    case MODE_VMEM: return (int)launch_probe<MODE_VMEM, -1>(noise, partials, scratch, nacc, n_steps, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
