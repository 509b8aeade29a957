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
//   mxu_fma128 (:132) m = bf16(m @ c), 128 x 128 x 128, chained, with f32
//                     accumulation: 2*128^3 tensor-core operations a
//                     pattern, one SM's (the noise keeps to one block, as
//                     the parent's did). Each pattern depends on the last,
//                     but its 128 rows are independent chains (a row of the
//                     product needs that row of m and c), so the floor is
//                     that SM's bf16 tensor-core rate, 4,096 operations a
//                     clock: 1,024 clocks a pattern. The design: two
//                     warpgroups, each the chain of 64 rows, wgmma
//                     m64n128k16 with A from REGISTERS and c staged once in
//                     shared memory (16-byte copies, in the layout a B
//                     descriptor reads: MN-major, 128B swizzle). A
//                     pattern's f32 accumulators, rounded to bf16 pairs,
//                     are the next pattern's A fragments as they lie: no
//                     shared-memory traffic, no barrier between patterns,
//                     the two chains' products interleaved on the tensor
//                     cores. mma.sync fragments re-read from shared memory
//                     every pattern would move ~288 KB a pattern, more than
//                     twice the floor at 128 B a clock.
//   vmem_ld    (:161) accs[j % 4] += buf[off:off+8, :], off = (j*13) %
//                     max(rows-8, 1), buf staged in SHARED memory (the
//                     TPU's VMEM; volatile loads: the offsets repeat, and a
//                     repeated load must not be merged). One LDS a pattern.
//   hbm_stream (:200) acc += buf[t*T:(t+1)*T, :], t = (j*197) % n_tiles, a
//                     thread an element of the (T,128) tile: one coalesced
//                     ld.global.cg (L2 and beyond, never L1) a pattern, T*512
//                     bytes a pattern from a buffer larger than the 50 MB L2.
//                     Bound by device-memory bandwidth, which needs ~2 MB in
//                     flight: each thread keeps a ring of G_STREAM_RING
//                     loads in flight (32,768 threads x 4 B x 16), the tile
//                     index stepped, not taken modulo a pattern, and the
//                     run-time k tested once a call (one load at a time
//                     would wait a round trip a pattern).
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

#include "hopper.cuh"       // wgmma (bf16, B MN-major), its descriptor, fences
#include "loop_noise.cuh"   // block_tree_sum, Reduce, reduce_blocks, ld_l2, ld_l2_s32

#define G_THREADS 256
#define MXU_D 128
#define MXU_LD 136   // the final m's row stride in bf16 elements: 272 bytes, so
                     // a warp's fragment stores of 8 rows hit 32 banks
#define G_STREAM_RING 16   // hbm_stream's loads in flight a thread
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
// hbm_stream: a thread an element of the (T,128) tile, E = T*128, a ring of
// G_STREAM_RING loads in flight
// ---------------------------------------------------------------------------
// acc + the k tiles' elements, each added in pattern order. The load of
// pattern j + R is issued where pattern j's value is added; the tile index
// t_j = (j*197) % n_tiles is stepped (t += 197 % n_tiles, wrapped once: the
// card has no integer divider, and a modulo a pattern would cost more than
// the load). Full trips of R patterns run while two trips remain (j + 2R
// <= k); the last < 2R patterns take the ring's remaining loads.
template <int SK>
__device__ __forceinline__ float stream_patterns(const float* p, int E, int n_tiles, int k,
                                                 float a) {
  constexpr int R = G_STREAM_RING;
  const int step = 197 % n_tiles;
  int t = 0;   // the tile of the next load
  auto next = [&]() {
    const float v = ld_l2(p + (size_t)t * E);
    t += step;
    if (t >= n_tiles) t -= n_tiles;
    return v;
  };
  float r[R];   // r[i]: pattern j + i
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = i < k ? next() : 0.f;
  auto trip = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float v = r[i];
      r[i] = next();   // pattern j + R + i
      a = __fadd_rn(a, v);
    }
  };
  int j = 0;
  if constexpr (SK >= 0) {
#pragma unroll
    for (; j + 2 * R <= SK; j += R) trip();
  } else {
#pragma unroll 1
    for (; j + 2 * R <= k; j += R) trip();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (j + i < k) {
      const float v = r[i];
      if (j + R + i < k) r[i] = next();
      a = __fadd_rn(a, v);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (j + R + i < k) a = __fadd_rn(a, r[i]);
  return a;
}

template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gstream_kernel(const float* __restrict__ buf, const float* __restrict__ acc0,
               float* __restrict__ out, int E, int n_tiles, int k, Reduce rd) {
  __shared__ float sh[G_THREADS];
  const int e = blockIdx.x * G_THREADS + threadIdx.x;
  float a = 0.f;
  if (e < E) {
    a = acc0[e];
    if constexpr (SK > 0) {
      a = stream_patterns<SK>(buf + e, E, n_tiles, SK, a);
    } else if constexpr (SK < 0) {
      if (k > 0) a = stream_patterns<SK>(buf + e, E, n_tiles, k, a);   // once a call
    }
    out[e] = a;
  }
  reduce_blocks<G_THREADS>(0.f, a, rd, sh);
}

// ---------------------------------------------------------------------------
// mxu_fma128: one block, two warpgroups, warpgroup h the rows 64h..64h+63 of
// m, their chains in registers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// c: two 16 KiB halves (columns 0..63, 64..127), each 128 K-rows of 128
// bytes in the 128B swizzle (hopper.cuh desc_sw128_mn); then the final m,
// row stride MXU_LD, for the aux; 1 KiB for the swizzle's alignment
#define MXU_HALF_BYTES (MXU_D * 64 * 2)
#define MXU_SMEM (1024 + 2 * MXU_HALF_BYTES + MXU_D * MXU_LD * 2)

template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gmxu_kernel(const __nv_bfloat16* __restrict__ m0, const __nv_bfloat16* __restrict__ c,
            __nv_bfloat16* __restrict__ mout, float* __restrict__ res, int k) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float sh[G_THREADS];
  uint8_t* cs = align_1024(smraw);
  __nv_bfloat16* ms = reinterpret_cast<__nv_bfloat16*>(cs + 2 * MXU_HALF_BYTES);
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;   // warp w's rows: 16w..16w+15 (warpgroup w / 4)
  // a[4s..4s+3]: this thread's A fragment of k-step s (columns 16s..16s+15)
  uint32_t a[32];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const __nv_bfloat16* p = m0 + (r0 + g) * MXU_D + 16 * s + 2 * t;
    a[4 * s] = ld_pair(p);
    a[4 * s + 1] = ld_pair(p + 8 * MXU_D);
    a[4 * s + 2] = ld_pair(p + 8);
    a[4 * s + 3] = ld_pair(p + 8 * MXU_D + 8);
  }
  if (SK > 0 || (SK < 0 && k > 0)) {
    // c in 16-byte pieces: piece i is row i / 16, columns 8(i % 16) ..
    for (int i = tid; i < MXU_D * MXU_D / 8; i += G_THREADS) {
      const int kk = i >> 4, q = i & 15;
      *reinterpret_cast<uint4*>(cs + (q >> 3) * MXU_HALF_BYTES + kk * 128 +
                                (((q & 7) ^ (kk & 7)) << 4)) =
          __ldg(reinterpret_cast<const uint4*>(c) + i);
    }
    fence_proxy_async();   // the stores visible to wgmma
    __syncthreads();
    // k-step s reads c's K-rows 16s..16s+15: 2048 bytes on
    const uint64_t db = desc_sw128_mn(cs, MXU_HALF_BYTES, 1024);
    auto pattern = [&]() {
      float d[64];
      wgmma_fence();   // a was written since the last product read it
#pragma unroll
      for (int s = 0; s < 8; ++s)
        wgmma_m64n128k16_rs_bf16(d, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                                 db + (uint64_t)(s * (2048 >> 4)), s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      // the product's columns 16s..16s+15 are the next A fragment of k-step s
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
    };
    if constexpr (SK >= 0) {
      // unrolled, each pattern behind a test of the run-time k (the static
      // entry passes SK): a basic block a pattern keeps ptxas's time near
      // linear in k (on the H100's machine, nvcc end to end: one block of
      // all the patterns 384.9 s at k = 64; a block a pattern 30.0 s, and
      // 97.4 s at k = 128; tools/torch_graph_bench.py --build-times)
#pragma unroll
      for (int j = 0; j < SK; ++j)
        if (j < k) pattern();
    } else {
      for (int j = 0; j < k; ++j) pattern();
    }
  }
  // m to shared memory once, then out and the aux in one_block_sum's order
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    __nv_bfloat16* p = ms + (r0 + g) * MXU_LD + 16 * s + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = a[4 * s];
    *reinterpret_cast<uint32_t*>(p + 8 * MXU_LD) = a[4 * s + 1];
    *reinterpret_cast<uint32_t*>(p + 8) = a[4 * s + 2];
    *reinterpret_cast<uint32_t*>(p + 8 * MXU_LD + 8) = a[4 * s + 3];
  }
  __syncthreads();
  for (int i = tid; i < MXU_D * MXU_D / 8; i += G_THREADS)
    reinterpret_cast<uint4*>(mout)[i] =
        *reinterpret_cast<const uint4*>(ms + (i >> 4) * MXU_LD + (i & 15) * 8);
  float s = 0.f;
  for (int e = tid; e < MXU_D * MXU_D; e += G_THREADS)
    s = __fadd_rn(s, __bfloat162float(ms[(e >> 7) * MXU_LD + (e & 127)]));
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
