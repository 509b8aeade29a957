// Graph-level noise modes on Hopper: the device side of
// repro_torch/core/noise.py (kernels/graph_noise/kernel.py wraps it).
//
// Replaces: the pattern emitters of src/repro/core/noise.py, which are no
// Pallas kernels but XLA ops: `apply` unrolls k patterns into the jitted
// step, `apply_rt` runs them in a lax.fori_loop, and XLA fuses either into
// the step's program. The same patterns as PyTorch operations would launch
// one kernel a pattern, and k launch gaps would swamp the patterns they
// carry. So each mode is one kernel a call, with k a run-time argument
// (the runtime library) or unrolled (-DREPRO_STATIC_MODE/-DREPRO_STATIC_K,
// the static build), pattern j doing the same arithmetic in both:
//
//   fp_add32   (:101) accs[j % 4] += c over (rows,128) f32; a thread an
//                     element: one FADD a pattern. Bound by FP32 issue
//                     (rows*128 adds a pattern). The ici modes' no-mesh
//                     branch (:290) runs it on (1,128) with c = v[:128] * 1e-3.
//   mxu_fma128 (:132) m = bf16(m @ c), 128 x 128 x 128, chained: one block
//                     of 8 warps, warp w the rows 16w..16w+15, mma.sync
//                     m16n8k16 bf16 with f32 accumulation (a tensor-core
//                     product, 128 HMMA a warp a pattern), m double-buffered
//                     in shared memory, c staged transposed. Bound by the
//                     chain: each product needs the last.
//   vmem_ld    (:161) accs[j % 4] += buf[off:off+8, :], off = (j*13) %
//                     max(rows-8, 1), buf staged in SHARED memory (the
//                     TPU's VMEM; volatile loads: the offsets repeat, and a
//                     repeated load must not be merged). One LDS a pattern.
//   hbm_stream (:200) acc += buf[t*T:(t+1)*T, :], t = (j*197) % n_tiles, a
//                     thread an element of the (T,128) tile: one coalesced
//                     ld.global.cg (L2 and beyond, never L1) a pattern, T*512
//                     bytes a pattern from a buffer larger than the 50 MB L2.
//                     Bound by device-memory bandwidth.
//   hbm_latency(:241) idx = table[idx]; acc += idx: one thread walks a
//                     single-cycle table, one dependent ld.global.cg a
//                     pattern. Bound by load latency.
// (The ici modes' other no-mesh branch, sum(v), is torch.sum: no noise
// pattern, no kernel of its own.)
//
// aux: the f32 modes sum their state in the kernel's own epilogue
// (reduce_blocks, loop_noise.cuh): a tree over each block's 256 threads,
// then the last block adds the block sums (kernels/graph_noise/ref.py
// follows that order, so the card's aux is bitwise its plain version's).
// fp_add32 and vmem_ld report 0 at static k = 0, as the reference's `apply`
// does; their run-time k = 0 sums the carried accumulators, as `apply_rt`.
// States are written out of place: the inputs stay as they were (the
// reference's functional semantics).
#include <cuda_bf16.h>

#include "loop_noise.cuh"   // block_tree_sum, Reduce, reduce_blocks, ld_l2, ld_l2_s32

#define G_THREADS 256
#define MXU_D 128
#define MXU_LD 136   // shared row stride in bf16 elements: 272 bytes, so the
                     // fragment loads of a warp's 8 rows hit 32 banks
#define VMEM_MAX_ROWS 448   // vmem_ld's buffer in shared memory: 224 KiB at most

// mode ids (kernels/graph_noise/kernel.py MODE_IDS); macros, as the static
// build selects its entry with #if
#define GMODE_FP_ADD32 1
#define GMODE_MXU 2
#define GMODE_VMEM 3
#define GMODE_STREAM 4
#define GMODE_CHASE 5

// Pattern j of k into chain j % 4, the chain a compile-time index (no
// local-memory array): fully unrolled for a static k (SK >= 0).
template <int SK, typename F>
__device__ __forceinline__ void round_robin(int k, F&& f) {
  using C0 = std::integral_constant<int, 0>;
  using C1 = std::integral_constant<int, 1>;
  using C2 = std::integral_constant<int, 2>;
  using C3 = std::integral_constant<int, 3>;
  if constexpr (SK >= 0) {
#pragma unroll
    for (int j = 0; j < SK; j += 4) {
      f(C0{}, j);
      if (j + 1 < SK) f(C1{}, j + 1);
      if (j + 2 < SK) f(C2{}, j + 2);
      if (j + 3 < SK) f(C3{}, j + 3);
    }
  } else {
    int j = 0;
    for (; j + 4 <= k; j += 4) {
      f(C0{}, j);
      f(C1{}, j + 1);
      f(C2{}, j + 2);
      f(C3{}, j + 3);
    }
    if (j < k) f(C0{}, j);
    if (j + 1 < k) f(C1{}, j + 1);
    if (j + 2 < k) f(C2{}, j + 2);
  }
}

__device__ __forceinline__ float chains_sum(const float (&acc)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// The four accumulators of the fp and vmem modes as the wrapper passes them
struct Accs {
  const float* in[4];   // the state's accs (each E floats)
  float* out;           // the new accs, 4 x E floats
};

// ---------------------------------------------------------------------------
// fp_add32: a thread an element of the (rows,128) tiles
// ---------------------------------------------------------------------------
template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gfp_kernel(const float* __restrict__ c, Accs ac, int E, int ici, int k, int lit0, Reduce rd) {
  __shared__ float sh[G_THREADS];
  const int e = blockIdx.x * G_THREADS + threadIdx.x;
  float v = 0.f;
  if (e < E) {
    const float ce = ici ? __fmul_rn(c[e], 1e-3f) : c[e];   // ici: v[:128] * 1e-3
    float acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = ac.in[r][e];
    round_robin<SK>(k, [&](auto ch, int) {
      acc[decltype(ch)::value] = __fadd_rn(acc[decltype(ch)::value], ce);
    });
#pragma unroll
    for (int r = 0; r < 4; ++r) ac.out[(size_t)r * E + e] = acc[r];
    v = chains_sum(acc);
  }
  reduce_blocks<G_THREADS>(0.f, lit0 ? 0.f : v, rd, sh);
}

// ---------------------------------------------------------------------------
// vmem_ld: a thread an element of the (8,128) accumulators, buf in shared
// ---------------------------------------------------------------------------
template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gvmem_kernel(const float* __restrict__ buf, Accs ac, int rows, int k, int lit0, Reduce rd) {
  extern __shared__ __align__(16) unsigned char sraw[];
  __shared__ float sh[G_THREADS];
  float* sbuf = reinterpret_cast<float*>(sraw);   // rows x 128
  const int tid = threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(buf);
  for (int i = tid; i < rows * 32; i += G_THREADS)
    reinterpret_cast<float4*>(sbuf)[i] = __ldg(src + i);
  __syncthreads();
  const int e = blockIdx.x * G_THREADS + tid;   // < 1024: 4 blocks
  const int r = e >> 7, col = e & 127;
  const int m = rows - 8 > 1 ? rows - 8 : 1;
  const volatile float* vs = sbuf;
  float acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = ac.in[q][e];
  round_robin<SK>(k, [&](auto ch, int j) {
    const int off = (j * 13) % m;
    acc[decltype(ch)::value] = __fadd_rn(acc[decltype(ch)::value], vs[(off + r) * 128 + col]);
  });
#pragma unroll
  for (int q = 0; q < 4; ++q) ac.out[(size_t)q * 1024 + e] = acc[q];
  reduce_blocks<G_THREADS>(0.f, lit0 ? 0.f : chains_sum(acc), rd, sh);
}

// ---------------------------------------------------------------------------
// hbm_stream: a thread an element of the (T,128) tile, E = T*128
// ---------------------------------------------------------------------------
template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gstream_kernel(const float* __restrict__ buf, const float* __restrict__ acc0,
               float* __restrict__ out, int E, int n_tiles, int k, Reduce rd) {
  __shared__ float sh[G_THREADS];
  const int e = blockIdx.x * G_THREADS + threadIdx.x;
  float a = 0.f;
  if (e < E) {
    a = acc0[e];
    repeat_k<SK>(k, [&](int j) {
      const int t = (j * 197) % n_tiles;
      a = __fadd_rn(a, ld_l2(buf + (size_t)t * E + e));
    });
    out[e] = a;
  }
  reduce_blocks<G_THREADS>(0.f, a, rd, sh);
}

// ---------------------------------------------------------------------------
// mxu_fma128: one block, warp w the output rows 16w .. 16w+15
// ---------------------------------------------------------------------------
// d += A(16x16, row) * B(16x8, col), bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

#define MXU_SMEM (3 * MXU_D * MXU_LD * 2)   // m twice, c transposed

template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gmxu_kernel(const __nv_bfloat16* __restrict__ m0, const __nv_bfloat16* __restrict__ c,
            __nv_bfloat16* __restrict__ mout, float* __restrict__ res, int k) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float sh[G_THREADS];
  __nv_bfloat16* smx = reinterpret_cast<__nv_bfloat16*>(smraw);   // m, twice
  __nv_bfloat16* ct = smx + 2 * MXU_D * MXU_LD;   // ct[n][kk] = c[kk][n]
  const int tid = threadIdx.x;
  for (int i = tid; i < MXU_D * MXU_D / 8; i += G_THREADS) {   // 16-byte rows pieces
    const int r = i >> 4, c8 = (i & 15) * 8;
    *reinterpret_cast<uint4*>(smx + r * MXU_LD + c8) =
        __ldg(reinterpret_cast<const uint4*>(m0) + i);
  }
  for (int i = tid; i < MXU_D * MXU_D; i += G_THREADS) {
    const int kk = i >> 7, n = i & 127;
    ct[n * MXU_LD + kk] = c[i];
  }
  __syncthreads();
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;
  int cur = 0;
  repeat_k<SK>(k, [&](int) {
    const __nv_bfloat16* A = smx + cur * (MXU_D * MXU_LD);
    __nv_bfloat16* D = smx + (cur ^ 1) * (MXU_D * MXU_LD);
    float d[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[nt][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MXU_D / 16; ++ks) {
      const int kc = ks * 16;
      const uint32_t a[4] = {ld_pair(A + (r0 + g) * MXU_LD + kc + 2 * t),
                             ld_pair(A + (r0 + g + 8) * MXU_LD + kc + 2 * t),
                             ld_pair(A + (r0 + g) * MXU_LD + kc + 2 * t + 8),
                             ld_pair(A + (r0 + g + 8) * MXU_LD + kc + 2 * t + 8)};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const __nv_bfloat16* B = ct + (nt * 8 + g) * MXU_LD + kc + 2 * t;
        mma_bf16(d[nt], a, ld_pair(B), ld_pair(B + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(D + (r0 + g) * MXU_LD + col) = pack_bf16(d[nt][0], d[nt][1]);
      *reinterpret_cast<uint32_t*>(D + (r0 + g + 8) * MXU_LD + col) =
          pack_bf16(d[nt][2], d[nt][3]);
    }
    __syncthreads();   // D complete before it is read; A read before it is rewritten
    cur ^= 1;
  });
  const __nv_bfloat16* M = smx + cur * (MXU_D * MXU_LD);
  float s = 0.f;
  for (int e = tid; e < MXU_D * MXU_D; e += G_THREADS) {
    const __nv_bfloat16 x = M[(e >> 7) * MXU_LD + (e & 127)];
    mout[e] = x;
    s = __fadd_rn(s, __bfloat162float(x));
  }
  s = block_tree_sum<G_THREADS>(s, sh);
  if (tid == 0) res[1] = s;
}

// ---------------------------------------------------------------------------
// hbm_latency: one thread walks the chain
// ---------------------------------------------------------------------------
template <int SK>
__global__ void gchase_kernel(const int* __restrict__ table, const int* __restrict__ idx0,
                              const int* __restrict__ acc0, int* __restrict__ idx_out,
                              int* __restrict__ acc_out, int k) {
  if (threadIdx.x != 0) return;
  int idx = *idx0;
  unsigned acc = (unsigned)*acc0;   // int32 adds wrap, as the reference's
  repeat_k<SK>(k, [&](int) {
    idx = ld_l2_s32(table + idx);
    acc += (unsigned)idx;
  });
  *idx_out = idx;
  *acc_out = (int)acc;
}

// ---------------------------------------------------------------------------
// launchers, one per mode: MODE's kernel at SK (-1: run-time k)
// ---------------------------------------------------------------------------
static inline int g_blocks(int E) { return (E + G_THREADS - 1) / G_THREADS; }

template <int SK>
static cudaError_t launch_gfp(const float* c, Accs ac, Reduce rd, int E, int ici, int k,
                              int lit0, cudaStream_t st) {
  gfp_kernel<SK><<<g_blocks(E), G_THREADS, 0, st>>>(c, ac, E, ici, k, lit0, rd);
  return cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gvmem(const float* buf, Accs ac, Reduce rd, int rows, int k, int lit0,
                                cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  const int bytes = rows * 128 * 4;
  cudaError_t e = allow_smem_once(gvmem_kernel<SK>, VMEM_MAX_ROWS * 128 * 4, done);
  if (e != cudaSuccess) return e;
  gvmem_kernel<SK><<<1024 / G_THREADS, G_THREADS, bytes, st>>>(buf, ac, rows, k, lit0, rd);
  return cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gstream(const float* buf, const float* acc0, float* out, Reduce rd,
                                  int E, int n_tiles, int k, cudaStream_t st) {
  gstream_kernel<SK><<<g_blocks(E), G_THREADS, 0, st>>>(buf, acc0, out, E, n_tiles, k, rd);
  return cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gmxu(const void* m0, const void* c, void* mout, float* res, int k,
                               cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(gmxu_kernel<SK>, MXU_SMEM, done);
  if (e != cudaSuccess) return e;
  gmxu_kernel<SK><<<1, G_THREADS, MXU_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(m0), static_cast<const __nv_bfloat16*>(c),
      static_cast<__nv_bfloat16*>(mout), res, k);
  return cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gchase(const int* table, const int* idx0, const int* acc0, int* idx_out,
                                 int* acc_out, int k, cudaStream_t st) {
  gchase_kernel<SK><<<1, 32, 0, st>>>(table, idx0, acc0, idx_out, acc_out, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C entries. Pointers first, then ints; the run-time library's entries end
// with (mode, k, stream), k clipped to [0, LOOP_K_MAX]; a static build
// (-DREPRO_STATIC_MODE=<mode>, -DREPRO_STATIC_K=<k>) has the one entry
// repro_<mode>_static(..., stream) of its mode. fp and vmem take the four
// accumulators, the new accumulators, then the reduction's parts, ticket
// counter and res (2 floats: [unused, aux]). fp's `ici` (0 or 1) scales c
// by 1e-3: the ici modes' no-mesh fallback state.
// ---------------------------------------------------------------------------
#define ACC_PARAMS const float *a0, const float *a1, const float *a2, const float *a3, float *accs_out
#define ACCS Accs{{a0, a1, a2, a3}, accs_out}
#define RED_PARAMS float *parts, unsigned *counter, float *res
#define RD Reduce{parts, counter, res}

#ifdef REPRO_STATIC_K
#if REPRO_STATIC_MODE == GMODE_FP_ADD32
extern "C" int repro_gfp_static(const float* c, ACC_PARAMS, RED_PARAMS, int E, int ici,
                                void* stream) {
  return (int)launch_gfp<REPRO_STATIC_K>(c, ACCS, RD, E, ici, REPRO_STATIC_K,
                                         REPRO_STATIC_K == 0, (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_MXU
extern "C" int repro_gmxu_static(const void* m0, const void* c, void* mout, float* res,
                                 void* stream) {
  return (int)launch_gmxu<REPRO_STATIC_K>(m0, c, mout, res, REPRO_STATIC_K, (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_VMEM
extern "C" int repro_gvmem_static(const float* buf, ACC_PARAMS, RED_PARAMS, int rows,
                                  void* stream) {
  return (int)launch_gvmem<REPRO_STATIC_K>(buf, ACCS, RD, rows, REPRO_STATIC_K,
                                           REPRO_STATIC_K == 0, (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_STREAM
extern "C" int repro_gstream_static(const float* buf, const float* acc0, float* out, RED_PARAMS,
                                    int E, int n_tiles, void* stream) {
  return (int)launch_gstream<REPRO_STATIC_K>(buf, acc0, out, RD, E, n_tiles, REPRO_STATIC_K,
                                             (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_CHASE
extern "C" int repro_gchase_static(const int* table, const int* idx0, const int* acc0,
                                   int* idx_out, int* acc_out, void* stream) {
  return (int)launch_gchase<REPRO_STATIC_K>(table, idx0, acc0, idx_out, acc_out, REPRO_STATIC_K,
                                            (cudaStream_t)stream);
}
#endif
#else
extern "C" int repro_gfp_rt(const float* c, ACC_PARAMS, RED_PARAMS, int E, int ici, int mode,
                            int k, void* stream) {
  return (int)launch_gfp<-1>(c, ACCS, RD, E, ici, loop_clip_k(k), 0,
                             (cudaStream_t)stream);
}

extern "C" int repro_gmxu_rt(const void* m0, const void* c, void* mout, float* res, int mode,
                             int k, void* stream) {
  return (int)launch_gmxu<-1>(m0, c, mout, res, loop_clip_k(k), (cudaStream_t)stream);
}

extern "C" int repro_gvmem_rt(const float* buf, ACC_PARAMS, RED_PARAMS, int rows, int mode, int k,
                              void* stream) {
  return (int)launch_gvmem<-1>(buf, ACCS, RD, rows, loop_clip_k(k), 0, (cudaStream_t)stream);
}

extern "C" int repro_gstream_rt(const float* buf, const float* acc0, float* out, RED_PARAMS, int E,
                                int n_tiles, int mode, int k, void* stream) {
  return (int)launch_gstream<-1>(buf, acc0, out, RD, E, n_tiles, loop_clip_k(k),
                                 (cudaStream_t)stream);
}

extern "C" int repro_gchase_rt(const int* table, const int* idx0, const int* acc0, int* idx_out,
                               int* acc_out, int mode, int k, void* stream) {
  return (int)launch_gchase<-1>(table, idx0, acc0, idx_out, acc_out, loop_clip_k(k),
                                (cudaStream_t)stream);
}

#endif
