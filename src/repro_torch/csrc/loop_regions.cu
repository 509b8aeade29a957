// The paper's validation loops (its Sec. 4 and Fig. 4) as CUDA kernels for
// Hopper (sm_90a), each with a loop-body noise slot (loop_noise.cuh).
//
// Replaces: the regions of src/repro/bench/kernels.py, which are no Pallas
// kernels but XLA loops: each is one jax.jit of a lax.fori_loop, compiled
// with its noise patterns into one device program. The same loop as a Python
// loop of PyTorch operations would launch tens of thousands of small kernels
// a call (STREAM at n = 2^25, chunk 512: 65,536 iterations), and launch gaps
// would absorb any injected noise. So each region is one kernel whose loop
// body holds the noise slot, as the paper's LLVM pass puts it:
//
//   stream_triad  (:31)  c = a + 3 b in chunks of 512; bound by device
//                        memory: 12 bytes an element
//   lat_mem_rd    (:58)  hops_per_iter dependent loads an iteration through a
//                        random cyclic table; bound by load latency, not by
//                        bytes or operations
//   haccmk        (:92)  six chains of the degree-2 HACC polynomial per lane;
//                        bound by FP32 issue (8 operations a chain-step)
//   spmxv         (:125) ELL y = A x, 64 rows an iteration, the q-irregular
//                        gather of x; bound by device memory (the bytes of
//                        spmv_ell)
//   matmul_O0/O3  (:160) rank-1 updates of one output row ("-O0": through
//                        memory every step) or of eight rows held in
//                        registers ("-O3")
//
// Mapping of the reference's sequential loop onto the card:
// * independent iterations (STREAM chunks, SPMXV row blocks): one warp owns
//   one iteration, warps walk the iterations grid-stride (n_warps warps, a
//   constant of the wrapper, so the noise grouping is the same on every
//   card and in the plain version);
// * a loop-carried dependence stays in one thread: lat_mem_rd's index (one
//   warp, every lane walking the same chain, so a noise pattern is one
//   warp-wide instruction), haccmk's accumulators (one thread per lane of
//   `width`), the matmul's output row and accumulators (one thread per
//   column).
// Each thread keeps its own noise carry and emits k patterns per iteration it
// runs (loop_noise.cuh). Outputs and noise carries are summed the same way,
// in the kernel's own epilogue (reduce_blocks): each thread's value, a tree
// over the block's NT threads (block_tree_sum); then the last block to
// finish (the ticket of noise_slots.cuh's reduce_fused) has thread t add the
// block sums t, t+NT, ... in order, and a tree over its NT sums.
// kernels/loop_regions/ref.py is that order in plain PyTorch, so the aux and
// the scalar outputs match it bit for bit. All arithmetic is __fadd_rn /
// __fmul_rn (no contraction into FMAs): the plain versions round each
// operation as the kernels do.
//
// The iteration loops are not unrolled (#pragma unroll 1), as XLA keeps a
// fori_loop: one machine-loop iteration is one reference iteration, and the
// static-k SASS holds k patterns per region kernel (chip_smoke.py's census
// counts them; lat_kernel holds its fp patterns twice, as nvcc versions its
// loop on hops > 0, and each iteration runs one copy).
//
// One launch a call. Its scratch is the stream's noise_slots workspace
// (kernels/noise_slots.py `Workspace`): parts, 2 floats a block ([output,
// aux]), and one ticket counter, 0 on entry and on exit; res: 2 floats.
#include "loop_noise.cuh"   // LoopNoise, reduce_blocks

#define LOOP_THREADS 256
#define LOOP_WARPS_PER_BLOCK (LOOP_THREADS / 32)

static inline NoiseArgs noise_args(const float* nf, const float* nacc0, const int* ntab,
                                   const int* nidx0, int rows_mask) {
  return NoiseArgs{nf, nacc0, ntab, nidx0, (unsigned)rows_mask};
}

// ---------------------------------------------------------------------------
// stream_triad: c[i*chunk + e] = a + 3 b, warp per chunk
// ---------------------------------------------------------------------------
template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
stream_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
              int n_iter, int chunk, int n_warps, NoiseArgs na, int k, Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * LOOP_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  LoopNoise<MODE, SK> nz;
  nz.init(na, lane & (LOOP_VEC - 1));
  const bool active = w < n_warps;
  if (active) {
#pragma unroll 1
    for (int i = w; i < n_iter; i += n_warps) {
      const size_t off = (size_t)i * chunk;
      if ((chunk & 3) == 0) {
        const float4* a4 = reinterpret_cast<const float4*>(a + off);
        const float4* b4 = reinterpret_cast<const float4*>(b + off);
        float4* c4 = reinterpret_cast<float4*>(c + off);
        for (int e = lane; e < chunk / 4; e += 32) {
          const float4 x = __ldg(a4 + e), y = __ldg(b4 + e);
          float4 z;
          z.x = __fadd_rn(x.x, __fmul_rn(3.f, y.x));
          z.y = __fadd_rn(x.y, __fmul_rn(3.f, y.y));
          z.z = __fadd_rn(x.z, __fmul_rn(3.f, y.z));
          z.w = __fadd_rn(x.w, __fmul_rn(3.f, y.w));
          c4[e] = z;
        }
      } else {
        for (int e = lane; e < chunk; e += 32)
          c[off + e] = __fadd_rn(__ldg(a + off + e), __fmul_rn(3.f, __ldg(b + off + e)));
      }
      nz.emit(k, i);
    }
  }
  reduce_blocks<LOOP_THREADS>(0.f, active ? nz.finalize() : 0.f, rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_stream(const float* a, const float* b, float* c, NoiseArgs na,
                                 Reduce rd, int n_iter, int chunk, int n_warps,
                                 int k, cudaStream_t st) {
  const int blocks = (n_warps + LOOP_WARPS_PER_BLOCK - 1) / LOOP_WARPS_PER_BLOCK;
  stream_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(a, b, c, n_iter, chunk, n_warps, na,
                                                           k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lat_mem_rd: one warp walks the chain, hops dependent loads an iteration
// ---------------------------------------------------------------------------
template <int MODE, int SK>
__global__ void __launch_bounds__(32)
lat_kernel(const int* __restrict__ table, const int* __restrict__ idx0, int n_iter, int hops,
           NoiseArgs na, int k, Reduce rd) {
  __shared__ float sh[32];
  LoopNoise<MODE, SK> nz;
  nz.init(na, threadIdx.x & (LOOP_VEC - 1));
  int idx = *idx0;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    for (int h = 0; h < hops; ++h) idx = table[idx];
    nz.emit(k, i);
  }
  reduce_blocks<32>(threadIdx.x == 0 ? __int2float_rn(idx) : 0.f, nz.finalize(), rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_lat(const int* table, const int* idx0, NoiseArgs na, Reduce rd,
                              int n_iter, int hops, int k, cudaStream_t st) {
  lat_kernel<MODE, SK><<<1, 32, 0, st>>>(table, idx0, n_iter, hops, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// haccmk: thread t owns lane t of `width`, six accumulator chains
// ---------------------------------------------------------------------------
template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
haccmk_kernel(const float* __restrict__ x, int width, int n_iter, NoiseArgs na, int k,
              Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  const int t = blockIdx.x * LOOP_THREADS + threadIdx.x;
  LoopNoise<MODE, SK> nz;
  nz.init(na, threadIdx.x & (LOOP_VEC - 1));
  float out = 0.f, aux = 0.f;
  if (t < width) {
    const float x0 = x[t];
    float acc[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j] = __fadd_rn(x0, (float)j);
#pragma unroll 1
    for (int i = 0; i < n_iter; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        // f(r) = r*(c1 + r2*(c2 + r2*c3)), a += f * 1e-6
        const float a = acc[j];
        const float r2 = __fmul_rn(a, a);
        float f = __fadd_rn(0.25f, __fmul_rn(r2, 0.125f));
        f = __fadd_rn(0.5f, __fmul_rn(r2, f));
        f = __fmul_rn(a, f);
        acc[j] = __fadd_rn(a, __fmul_rn(f, 1e-6f));
      }
      nz.emit(k, i);
    }
    out = acc[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) out = __fadd_rn(out, acc[j]);
    aux = nz.finalize();
  }
  reduce_blocks<LOOP_THREADS>(out, aux, rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_haccmk(const float* x, NoiseArgs na, Reduce rd,
                                 int width, int n_iter, int k, cudaStream_t st) {
  const int blocks = (width + LOOP_THREADS - 1) / LOOP_THREADS;
  haccmk_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(x, width, n_iter, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spmxv: warp per block of rpi rows, lane per row, y[r] = sum_l v * x[col]
// ---------------------------------------------------------------------------
__device__ __forceinline__ float f4_at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ int i4_at(const int4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// W columns of one row added to s in column order, every load issued before
// the adds (W = 16: a row of the main path's L = 16 in flight at once,
// whatever registers the compiler gives the rest of the kernel)
template <int W>
__device__ __forceinline__ float row_step(const float* vr, const int* cr, const float* x, float s) {
  float4 v[W / 4];
  int4 c[W / 4];
  float g[W];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    v[q] = __ldg(reinterpret_cast<const float4*>(vr) + q);
    c[q] = __ldg(reinterpret_cast<const int4*>(cr) + q);
  }
#pragma unroll
  for (int u = 0; u < W; ++u) g[u] = __ldg(x + i4_at(c[u / 4], u % 4));
#pragma unroll
  for (int u = 0; u < W; ++u) s = __fadd_rn(s, __fmul_rn(f4_at(v[u / 4], u % 4), g[u]));
  return s;
}

template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
spmxv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
             const float* __restrict__ x, float* __restrict__ y, int n_iter, int rpi, int L,
             int n_warps, NoiseArgs na, int k, Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * LOOP_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  LoopNoise<MODE, SK> nz;
  nz.init(na, lane & (LOOP_VEC - 1));
  const bool active = w < n_warps;
  if (active) {
#pragma unroll 1
    for (int i = w; i < n_iter; i += n_warps) {
      const size_t r0 = (size_t)i * rpi;
      for (int h = lane; h < rpi; h += 32) {
        const size_t r = r0 + h;
        const float* vr = vals + r * L;
        const int* cr = cols + r * L;
        float s = 0.f;
        if ((L & 15) == 0) {
          for (int l = 0; l < L; l += 16) s = row_step<16>(vr + l, cr + l, x, s);
        } else if ((L & 3) == 0) {
          for (int l = 0; l < L; l += 4) s = row_step<4>(vr + l, cr + l, x, s);
        } else {
          for (int l = 0; l < L; ++l) s = __fadd_rn(s, __fmul_rn(__ldg(vr + l), __ldg(x + __ldg(cr + l))));
        }
        y[r] = s;
      }
      nz.emit(k, i);
    }
  }
  reduce_blocks<LOOP_THREADS>(0.f, active ? nz.finalize() : 0.f, rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_spmxv(const float* vals, const int* cols, const float* x, float* y,
                                NoiseArgs na, Reduce rd, int n_iter, int rpi, int L,
                                int n_warps, int k, cudaStream_t st) {
  const int blocks = (n_warps + LOOP_WARPS_PER_BLOCK - 1) / LOOP_WARPS_PER_BLOCK;
  spmxv_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(vals, cols, x, y, n_iter, rpi, L,
                                                          n_warps, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matmul_O0: thread per column j of the one output row, which makes a round
// trip through device memory at every step (volatile: "-O0", no mem2reg)
// ---------------------------------------------------------------------------
template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
mm_o0_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ out0, float* ob, int n, int n_iter, NoiseArgs na, int k,
             Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  const int j = blockIdx.x * LOOP_THREADS + threadIdx.x;
  LoopNoise<MODE, SK> nz;
  nz.init(na, threadIdx.x & (LOOP_VEC - 1));
  float out = 0.f, aux = 0.f;
  if (j < n) {
    volatile float* o = ob + j;
    *o = out0[j];
#pragma unroll 1
    for (int i = 0; i < n_iter; ++i) {
      const int kk = (i * 8) % n;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int ku = min(kk + u, n - 1);   // lax.dynamic_slice clamps its start
        const float av = __ldg(a + ku);
        const float bv = __ldg(b + (size_t)ku * n + j);
        *o = __fadd_rn(*o, __fmul_rn(av, bv));
      }
      nz.emit(k, i);
    }
    out = *o;
    aux = nz.finalize();
  }
  reduce_blocks<LOOP_THREADS>(out, aux, rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_mm_o0(const float* a, const float* b, const float* out0, float* ob,
                                NoiseArgs na, Reduce rd, int n, int n_iter, int k,
                                cudaStream_t st) {
  const int blocks = (n + LOOP_THREADS - 1) / LOOP_THREADS;
  mm_o0_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(a, b, out0, ob, n, n_iter, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matmul_O3: thread per column j, eight output rows in registers
// ---------------------------------------------------------------------------
template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
mm_o3_kernel(const float* __restrict__ a, const float* __restrict__ b, int n, int n_iter,
             NoiseArgs na, int k, Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  const int j = blockIdx.x * LOOP_THREADS + threadIdx.x;
  LoopNoise<MODE, SK> nz;
  nz.init(na, threadIdx.x & (LOOP_VEC - 1));
  float out = 0.f, aux = 0.f;
  if (j < n) {
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
#pragma unroll 1
    for (int i = 0; i < n_iter; ++i) {
      const int kk = i % n;
      const float bv = __ldg(b + (size_t)kk * n + j);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(__ldg(a + (size_t)r * n + kk), bv));
      nz.emit(k, i);
    }
    out = acc[0];
#pragma unroll
    for (int r = 1; r < 8; ++r) out = __fadd_rn(out, acc[r]);
    aux = nz.finalize();
  }
  reduce_blocks<LOOP_THREADS>(out, aux, rd, sh);
}

template <int MODE, int SK>
static cudaError_t launch_mm_o3(const float* a, const float* b, NoiseArgs na, Reduce rd, int n,
                                int n_iter, int k, cudaStream_t st) {
  const int blocks = (n + LOOP_THREADS - 1) / LOOP_THREADS;
  mm_o3_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(a, b, n, n_iter, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C entries: every one takes the four noise operands (nf, nacc0, ntab, nidx0)
// after the region's tensors, then parts, the ticket counter and res; the
// ints end with rows_mask. The static build (-DREPRO_STATIC_MODE,
// -DREPRO_STATIC_K) has repro_<region>_static, the run-time library
// repro_<region>_rt(..., mode, k, stream) with k clipped to [0, LOOP_K_MAX].
// ---------------------------------------------------------------------------
#define NOISE_PARAMS const float *nf, const float *nacc0, const int *ntab, const int *nidx0
#define NOISE_ARGS noise_args(nf, nacc0, ntab, nidx0, rows_mask)
#define REDUCE_PARAMS float *parts, unsigned *counter, float *res
#define RD Reduce{parts, counter, res}

#ifdef REPRO_STATIC_K
#define LOOP_ENTRY(NAME, PARAMS, INTS, CALL)                                      \
  extern "C" int repro_##NAME##_static(PARAMS, NOISE_PARAMS, REDUCE_PARAMS, INTS, \
                                       int rows_mask, void* stream) {             \
    constexpr int MODE = REPRO_STATIC_MODE;                                       \
    constexpr int SK = REPRO_STATIC_K;                                            \
    const int k = SK;                                                             \
    cudaStream_t st = (cudaStream_t)stream;                                       \
    return (int)CALL;                                                             \
  }
#else
#define LOOP_ENTRY(NAME, PARAMS, INTS, CALL)                                           \
  extern "C" int repro_##NAME##_rt(PARAMS, NOISE_PARAMS, REDUCE_PARAMS, INTS, int rows_mask, \
                                   int mode, int k_in, void* stream) {                   \
    const int k = loop_clip_k(k_in);                                                     \
    cudaStream_t st = (cudaStream_t)stream;                                              \
    return dispatch_mode(mode, [&](auto m) {                                             \
      constexpr int MODE = decltype(m)::value;                                           \
      constexpr int SK = -1;                                                             \
      return CALL;                                                                       \
    });                                                                                  \
  }
#endif

#define COMMA ,

LOOP_ENTRY(stream, const float* a COMMA const float* b COMMA float* c,
           int n_iter COMMA int chunk COMMA int n_warps,
           (launch_stream<MODE, SK>(a, b, c, NOISE_ARGS, RD, n_iter, chunk, n_warps, k, st)))

LOOP_ENTRY(lat, const int* table COMMA const int* idx0, int n_iter COMMA int hops,
           (launch_lat<MODE, SK>(table, idx0, NOISE_ARGS, RD, n_iter, hops, k, st)))

LOOP_ENTRY(haccmk, const float* x, int width COMMA int n_iter,
           (launch_haccmk<MODE, SK>(x, NOISE_ARGS, RD, width, n_iter, k, st)))

LOOP_ENTRY(spmxv, const float* vals COMMA const int* cols COMMA const float* x COMMA float* y,
           int n_iter COMMA int rpi COMMA int L COMMA int n_warps,
           (launch_spmxv<MODE, SK>(vals, cols, x, y, NOISE_ARGS, RD, n_iter, rpi, L, n_warps, k,
                                   st)))

LOOP_ENTRY(mm_o0, const float* a COMMA const float* b COMMA const float* out0 COMMA float* ob,
           int n COMMA int n_iter,
           (launch_mm_o0<MODE, SK>(a, b, out0, ob, NOISE_ARGS, RD, n, n_iter, k, st)))

LOOP_ENTRY(mm_o3, const float* a COMMA const float* b, int n COMMA int n_iter,
           (launch_mm_o3<MODE, SK>(a, b, NOISE_ARGS, RD, n, n_iter, k, st)))
