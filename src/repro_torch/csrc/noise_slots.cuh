// Noise slots on Hopper: the device side of repro_torch/kernels/noise_slots.py,
// shared by noise_probes.cu, spmv_ell.cu, noisy_matmul.cu and flash_attention.cu.
//
// The reference (src/repro/kernels/noise_slots.py) runs Pallas grid steps in
// order on one core, all adding into one (8,128) f32 `nacc` block. CTAs run
// concurrently, so here every CTA owns an (8,128) f32 PARTIAL, kept in
// registers (4 elements per thread, 256 threads) and written once when the
// CTA ends. The partials are summed per element in a fixed order (chunks of
// 32 partials in CTA order, then the chunk sums in order): deterministic, no
// floating-point atomics, so the runtime-k and static-k builds of a kernel
// give bitwise-equal `nacc`. Two ways to the same order:
//   reduce_fused   — in the kernel's own epilogue, one launch a call (the
//                    probe and spmv): the last CTA of each chunk sums it,
//                    the last chunk to finish sums the chunk sums;
//   reduce_partials — `nacc_reduce`, one or two launches after the kernel
//                    (the matmul and attention).
//
// Modes (one pattern each; k patterns per grid step of the reference):
//   fp   — acc += c, with c the (8,128) addend loaded once into registers.
//          __fadd_rn and no fast-math: nvcc may neither contract nor
//          reassociate the chain into k*c.
//   mxu  — acc += noise[0:8,:] @ noise on the tensor cores: mma.sync
//          m16n8k8 TF32 with an f32 accumulator. The 8-row A operand is
//          padded to the instruction's 16 rows with zeros (rows 8..15 of the
//          product are dropped). Operands are re-read from shared memory
//          through volatile loads for every pattern, as the TPU's dot
//          re-reads VMEM.
//   vmem — acc[:, :w] += src[off:off+8, :w] with src a block in SHARED
//          memory and off = (step*7 + j*13) % max(rows-8, 1). The offsets
//          repeat every 120 patterns, so the loads are volatile: the
//          compiler may not merge repeated reads of one address.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define REPRO_K_MAX 512
#define REPRO_THREADS 256
#define REPRO_NACC 1024        // 8 x 128 floats
#define REPRO_REDUCE_CHUNK 32  // partials summed in order into one chunk sum
#define REPRO_NZ_STRIDE 132    // row stride (floats) of a 128x128 operand staged
                               // in shared memory: 16-byte rows, and the mxu
                               // A-fragment reads hit 32 distinct banks

enum { MODE_NONE = 0, MODE_FP = 1, MODE_MXU = 2, MODE_VMEM = 3 };

// ---------------------------------------------------------------------------
// Ownership of the (8,128) partial: which element acc[r] of thread `tid` is.
//   none/fp/vmem: element tid + 256*r  -> row tid/128 + 2r, column tid%128
//   mxu:          the mma C-fragment layout: warp w covers columns
//                 w*16 .. w*16+15; lane (g = lane/4, t = lane%4) holds row g,
//                 columns (2w+q)*8 + 2t + h for r = 2q + h.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int own_row(int tid, int r) { return (tid >> 7) + 2 * r; }
__device__ __forceinline__ int own_col(int tid) { return tid & 127; }

template <int MODE>
__device__ __forceinline__ int slot_elem(int tid, int r) {
  if constexpr (MODE == MODE_MXU) {
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    return g * 128 + (2 * w + (r >> 1)) * 8 + 2 * t + (r & 1);
  } else {
    return tid + REPRO_THREADS * r;
  }
}

template <int MODE>
__device__ __forceinline__ void write_partial(float* part, const float (&acc)[4], int tid) {
#pragma unroll
  for (int r = 0; r < 4; ++r) part[slot_elem<MODE>(tid, r)] = acc[r];
}

// ---------------------------------------------------------------------------
// reduce_fused: the cross-CTA reduction in the kernel's epilogue.
//   workspace (kernels/noise_slots.py `Workspace`, one per device and
//   stream): partials P x 1024 floats, chunk sums C x 1024 floats
//   (C = ceil(P / 32)), counters 1 + C unsigned: [0] counts finished
//   chunks, [1 + c] the CTAs of chunk c that have written their partial.
// Every CTA writes its partial and takes a ticket on its chunk's counter.
// The chunk's last arriver sums the chunk's partials in CTA order (not in
// arrival order) into chunk sum c -- into nacc when C == 1 -- and takes a
// ticket on counter 0; the last chunk to finish sums the C chunk sums in
// order into nacc. That is nacc_reduce's order, so nacc is bitwise the
// same. Each last arriver sets the counter it consumed back to 0: the
// counters are 0 again when the launch ends, and the next launch on the
// stream needs no memset. Partials and chunk sums that other CTAs of this
// launch wrote are read through L2 (ld_coherent: ld.global.cg), never with
// __ldg: the non-coherent path may return stale lines.
// ---------------------------------------------------------------------------

// 16 bytes that other SMs wrote in this launch: through L2 (.cg, coherent
// across SMs), and volatile with a memory clobber, so the compiler keeps it
// after the barrier and fence that order it
__device__ __forceinline__ float4 ld_coherent(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// blocks whose loads are in flight at once: 16 registers, so the probe and
// spmv keep 8 CTAs an SM (32 registers a thread)
#define REPRO_SUM_BATCH 4

// Sum the n (8,128) blocks src[0], src[1024], ... in order into dst: thread
// tid owns elements 4*tid .. 4*tid+3. The loads of REPRO_SUM_BATCH blocks
// are in flight before their adds, so a chunk costs n / 4 round trips to L2,
// not n.
__device__ __forceinline__ void sum_in_order(const float* src, int n, float* dst, int tid) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < n; p0 += REPRO_SUM_BATCH) {
    float4 v[REPRO_SUM_BATCH];
#pragma unroll
    for (int j = 0; j < REPRO_SUM_BATCH; ++j)
      if (p0 + j < n) v[j] = ld_coherent(src + (size_t)(p0 + j) * REPRO_NACC + 4 * tid);
#pragma unroll
    for (int j = 0; j < REPRO_SUM_BATCH; ++j)
      if (p0 + j < n) {
        s.x = __fadd_rn(s.x, v[j].x);
        s.y = __fadd_rn(s.y, v[j].y);
        s.z = __fadd_rn(s.z, v[j].z);
        s.w = __fadd_rn(s.w, v[j].w);
      }
  }
  *reinterpret_cast<float4*>(dst + 4 * tid) = s;
}

// a release and acquire fence at device scope (lighter than __threadfence,
// whose fence.sc orders every memory operation device-wide)
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Called by every thread of the CTA after its writes: true in all of them
// when this CTA is the n-th and last to arrive on *counter, which it then
// resets to 0. One thread fences for the CTA, after the barrier that orders
// the others' writes before it (the pattern of cooperative groups' grid
// sync): its release covers them, its acquire the reads that follow.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned n, int tid) {
  __shared__ unsigned last;
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel_gpu();   // release: the CTA's writes before its ticket
    last = atomicAdd(counter, 1u) == n - 1;
    if (last) {
      *counter = 0u;         // every arrival has happened: nobody else touches it
      fence_acq_rel_gpu();   // acquire: the other CTAs' writes before our reads
    }
  }
  __syncthreads();
  return last;
}

template <int MODE>
__device__ __forceinline__ void reduce_fused(const float (&acc)[4], float* partials,
                                             float* chunk_sums, unsigned* counters, float* nacc,
                                             int cta, int P, int tid) {
  write_partial<MODE>(partials + (size_t)cta * REPRO_NACC, acc, tid);
  const int C = (P + REPRO_REDUCE_CHUNK - 1) / REPRO_REDUCE_CHUNK;
  const int c = cta / REPRO_REDUCE_CHUNK, p0 = c * REPRO_REDUCE_CHUNK;
  const int n = min(P - p0, REPRO_REDUCE_CHUNK);
  if (!last_to_arrive(counters + 1 + c, n, tid)) return;
  sum_in_order(partials + (size_t)p0 * REPRO_NACC, n,
               C == 1 ? nacc : chunk_sums + (size_t)c * REPRO_NACC, tid);
  if (C == 1 || !last_to_arrive(counters, C, tid)) return;
  sum_in_order(chunk_sums, C, nacc, tid);
}

// k patterns: fully unrolled when k is static (SK >= 0), a runtime loop
// otherwise. Pattern j does the same arithmetic in both.
template <int SK, typename F>
__device__ __forceinline__ void repeat_k(int k, F&& body) {
  if constexpr (SK >= 0) {
#pragma unroll
    for (int j = 0; j < SK; ++j) body(j);
  } else {
    for (int j = 0; j < k; ++j) body(j);
  }
}

// REPRO_NOISE_SABOTAGE (static builds under REPRO_NOISE_SABOTAGE=const, the
// static audit's fail-fast switch; never in a measuring run): the k adds run
// on a copy that never reaches the partial, so nvcc removes them and the
// audit must read the pair dead. A constant addend would not do: without
// fast-math the __fadd_rn chain survives whatever the addend is.
template <int SK>
__device__ __forceinline__ void fp_noise(float (&acc)[4], const float (&c)[4], int k) {
#ifdef REPRO_NOISE_SABOTAGE
  float lost[4] = {acc[0], acc[1], acc[2], acc[3]};
  repeat_k<SK>(k, [&](int) {
#pragma unroll
    for (int r = 0; r < 4; ++r) lost[r] = __fadd_rn(lost[r], c[r]);
  });
#else
  repeat_k<SK>(k, [&](int) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], c[r]);
  });
#endif
}

// src: `rows` x (>= w) floats in shared memory with row stride `stride`
template <int SK>
__device__ __forceinline__ void vmem_noise(float (&acc)[4], const float* src, int stride,
                                           int rows, int w, int step, int k, int tid) {
  const volatile float* vs = src;
  const int m = rows - 8 > 1 ? rows - 8 : 1;
  const int col = own_col(tid);
  if (col >= w) return;   // lanes >= w never change (the reference adds +0.0)
  repeat_k<SK>(k, [&](int j) {
    const int off = (step * 7 + j * 13) % m;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc[r] = __fadd_rn(acc[r], vs[(off + own_row(tid, r)) * stride + col]);
  });
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += A(16x8, row) * B(8x8, col); TF32 inputs, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// nz: the 128x128 noise operand in shared memory, row stride `stride`.
// One pattern: D = noise[0:8,:] @ noise (K = 128 in 16 mma steps, each warp
// two 8-column tiles), then acc += D, as the reference's nacc += dot(a, b).
template <int SK>
__device__ __forceinline__ void mxu_noise(float (&acc)[4], const float* nz, int stride, int k,
                                          int tid) {
  const volatile float* v = nz;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  repeat_k<SK>(k, [&](int) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n0 = (2 * w + q) * 8;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        const int kc = ks * 8;
        const uint32_t a0 = to_tf32(v[g * stride + kc + t]);
        const uint32_t a2 = to_tf32(v[g * stride + kc + t + 4]);
        const uint32_t b0 = to_tf32(v[(kc + t) * stride + n0 + g]);
        const uint32_t b1 = to_tf32(v[(kc + t + 4) * stride + n0 + g]);
        mma_tf32(d, a0, 0u, a2, 0u, b0, b1);   // A rows 8..15 are the zero pad
      }
      acc[2 * q] = __fadd_rn(acc[2 * q], d[0]);
      acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], d[1]);
    }
  });
}

// mxu_noise for kernels whose accumulators hold most of the registers (the
// wgmma matmul and attention): the same loads and products in the same
// order per 8-column tile, with the K loop unrolled by two only, so at most
// two k-steps' operands are in flight and nothing spills. mxu_noise stays
// where it fits (the probe): in the same kernel on the H100 this slot cost
// 7% (probe) to 22% (hd-256 attention's first, mma.sync, kernel) more a
// pattern (src/repro_torch/launch/slot_cost.py).
template <int SK>
__device__ __forceinline__ void mxu_noise_lean(float (&acc)[4], const float* nz, int stride, int k,
                                               int tid) {
  const volatile float* v = nz;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  repeat_k<SK>(k, [&](int) {
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int ks = 0; ks < 16; ++ks) {
      const int kc = ks * 8;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n0 = (2 * w + q) * 8;
        const uint32_t a0 = to_tf32(v[g * stride + kc + t]);
        const uint32_t a2 = to_tf32(v[g * stride + kc + t + 4]);
        const uint32_t b0 = to_tf32(v[(kc + t) * stride + n0 + g]);
        const uint32_t b1 = to_tf32(v[(kc + t + 4) * stride + n0 + g]);
        mma_tf32(d[q], a0, 0u, a2, 0u, b0, b1);   // A rows 8..15 are the zero pad
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      acc[2 * q] = __fadd_rn(acc[2 * q], d[q][0]);
      acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], d[q][1]);
    }
  });
}

// Copy a 128x128 f32 operand (16-byte aligned) into shared memory with row
// stride REPRO_NZ_STRIDE. The caller synchronises before use.
__device__ __forceinline__ void stage_noise(const float* __restrict__ noise, float* dst, int tid) {
  const float4* src = reinterpret_cast<const float4*>(noise);
  for (int i = tid; i < 128 * 32; i += REPRO_THREADS) {
    const int r = i >> 5, c4 = i & 31;
    *reinterpret_cast<float4*>(dst + r * REPRO_NZ_STRIDE + c4 * 4) = __ldg(src + i);
  }
}

// ---------------------------------------------------------------------------
// nacc_reduce: block b sums partials [b*chunk, min(P, b*chunk+chunk)) in
// order, one thread per element. Two launches: chunk sums into scratch, then
// one block sums the chunk sums into nacc (one launch when P <= chunk).
// ---------------------------------------------------------------------------
static __global__ void __launch_bounds__(REPRO_NACC)
nacc_reduce(const float* __restrict__ in, int P, int chunk, float* __restrict__ out) {
  const int e = threadIdx.x;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(P, p0 + chunk);
  float s = 0.f;
  for (int p = p0; p < p1; ++p) s = __fadd_rn(s, in[(size_t)p * REPRO_NACC + e]);
  out[(size_t)blockIdx.x * REPRO_NACC + e] = s;
}

// scratch: ceil(P / REPRO_REDUCE_CHUNK) * REPRO_NACC floats
static inline cudaError_t reduce_partials(const float* partials, int P, float* scratch, float* nacc,
                                          cudaStream_t st) {
  const int C = (P + REPRO_REDUCE_CHUNK - 1) / REPRO_REDUCE_CHUNK;
  nacc_reduce<<<C, REPRO_NACC, 0, st>>>(partials, P, REPRO_REDUCE_CHUNK, C == 1 ? nacc : scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || C == 1) return e;
  nacc_reduce<<<1, REPRO_NACC, 0, st>>>(scratch, C, C, nacc);
  return cudaGetLastError();
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// allow_smem once per device: `bytes` must be the most the kernel ever
// launches with, and `done` (a static of the caller, one per kernel
// instantiation) records the devices already opted in. Two threads racing
// on one device both set the same value.
template <typename Kernel>
static inline cudaError_t allow_smem_once(Kernel kernel, int bytes,
                                          std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  if ((e = allow_smem(kernel, bytes)) == cudaSuccess) done.fetch_or(bit);
  return e;
}

static inline int clip_k(int k) { return k < 0 ? 0 : (k > REPRO_K_MAX ? REPRO_K_MAX : k); }
