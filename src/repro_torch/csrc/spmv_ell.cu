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
// hits L1/L2; as q grows the gather becomes random and the kernel turns
// latency-bound (the paper's SPMXV knob, ROADMAP queue 2 item 3).
//
// Design:
// * Two threads per row, 128 rows (one block of the reference) per CTA
//   iteration; each thread reads L/2 contiguous vals and cols with 16-byte
//   __ldg loads (L must be a multiple of 8), so a warp's loads cover
//   contiguous memory. The two halves combine with one shuffle.
// * x stays in global memory behind L1/L2, read with __ldg: staging it in
//   shared memory would hide exactly the gather locality that q varies.
// * Noise partials: each CTA walks a contiguous run of bpc blocks in order
//   (step = block index, as in the reference), so there are ~1024 CTAs and
//   ~1024 partials of 4 KiB. At the main path's size that is 16 blocks per
//   CTA and 4 MiB of partials against ~285 MB of kernel traffic: 1.5% (the
//   reduction reads them once more).
// * fp: the addend is vals[blk*128 + 0..7, 0] broadcast across lanes, read
//   from device memory (L1) like the rest of the block. vmem: the block's
//   (128, w = min(L,128)) vals are written to shared memory from the
//   registers that already hold them, and re-read from there.
#include "noise_slots.cuh"

template <int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
            const float* __restrict__ x, float* __restrict__ y, float* __restrict__ partials,
            int nb, int L, int bpc, int k) {
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
  write_partial<MODE>(partials + (size_t)blockIdx.x * REPRO_NACC, acc, tid);
}

template <int MODE, int SK>
static cudaError_t launch_spmv(const float* vals, const int* cols, const float* x, float* y,
                               float* partials, float* scratch, float* nacc, int R, int L,
                               int bpc, int k, cudaStream_t st) {
  const int nb = R / 128;
  const int P = (nb + bpc - 1) / bpc;
  const int w = L < 128 ? L : 128;
  const int smem = MODE == MODE_VMEM ? 128 * w * (int)sizeof(float) : 0;
  cudaError_t e = allow_smem(spmv_kernel<MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  spmv_kernel<MODE, SK><<<P, REPRO_THREADS, smem, st>>>(vals, cols, x, y, partials, nb, L, bpc, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_partials(partials, P, scratch, nacc, st);
}

#ifdef REPRO_STATIC_K
extern "C" int repro_spmv_static(const float* vals, const int* cols, const float* x, float* y,
                                 float* partials, float* scratch, float* nacc, int R, int L,
                                 int bpc, void* stream) {
  return (int)launch_spmv<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      vals, cols, x, y, partials, scratch, nacc, R, L, bpc, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_spmv_rt(const float* vals, const int* cols, const float* x, float* y,
                             float* partials, float* scratch, float* nacc, int R, int L, int bpc,
                             int mode, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k = clip_k(k);
  switch (mode) {
    case MODE_NONE:
      return (int)launch_spmv<MODE_NONE, -1>(vals, cols, x, y, partials, scratch, nacc, R, L, bpc, k, st);
    case MODE_FP:
      return (int)launch_spmv<MODE_FP, -1>(vals, cols, x, y, partials, scratch, nacc, R, L, bpc, k, st);
    case MODE_VMEM:
      return (int)launch_spmv<MODE_VMEM, -1>(vals, cols, x, y, partials, scratch, nacc, R, L, bpc, k, st);
    default:
      return (int)cudaErrorInvalidValue;   // spmv has no noise operand, hence no mxu
  }
}
#endif
