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
// The iteration loops but matmul_O3's are not unrolled (#pragma unroll 1),
// as XLA keeps a fori_loop: one machine-loop iteration is one reference
// iteration, and the static-k SASS holds k patterns per region kernel
// (chip_smoke.py's census counts them; lat_kernel holds its fp patterns
// twice, as nvcc versions its loop on hops > 0, and each iteration runs one
// copy). matmul_O3 runs trips of MM_O3_UNROLL iterations, each with its own
// k patterns, and one iteration at a time across a wrap.
//
// One launch a call. Its scratch is the stream's noise_slots workspace
// (kernels/noise_slots.py `Workspace`): parts, 2 floats a block ([output,
// aux]), and one ticket counter, 0 on entry and on exit; res: 2 floats.
#include "loop_noise.cuh"   // LoopNoise, reduce_blocks
#include "triad.cuh"        // Triad512, triad_generic

#define LOOP_THREADS 256
#define LOOP_WARPS_PER_BLOCK (LOOP_THREADS / 32)

static inline NoiseArgs noise_args(const float* nf, const float* nacc0, const int* ntab,
                                   const int* nidx0, int rows_mask) {
  return NoiseArgs{nf, nacc0, ntab, nidx0, (unsigned)rows_mask};
}

// ---------------------------------------------------------------------------
// stream_triad: c[i*chunk + e] = a + 3 b, warp per chunk. Bound by device
// memory, 12 bytes an element. What held the old loop back and what the
// chunk routine does about it: triad.cuh. At chunk 512 the warp keeps its
// next chunk in flight while its noise slot runs (Triad512); other chunks
// take triad_generic. One loop with one noise slot serves both, so the
// static-k SASS holds k patterns.
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
  const bool fast = chunk == TRIAD_CHUNK;
  const size_t stride = (size_t)n_warps * TRIAD_CHUNK;
  Triad512 t;
  if (active && fast && w < n_iter) t.load(a, b, (size_t)w * TRIAD_CHUNK, lane);
  if (active) {
#pragma unroll 1
    for (int i = w; i < n_iter; i += n_warps) {
      const size_t off = (size_t)i * chunk;
      if (fast)
        t.advance(a, b, c, off, off + stride, i < n_iter - n_warps, lane);
      else
        triad_generic(a, b, c, off, chunk, lane);
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

// Whether a matmul kernel instance's loop holds the noise slot. The
// run-time build's k > 0 test is taken once a call, on the host: a run-time
// call at k = 0 launches the kernel's <MODE, 0> instance, its loop without
// the slot (the carry initialised and finalised, no pattern), compiled apart
// as the static builds are, so that its loop is the clean build's and not a
// branch beside the slot's loop that ptxas schedules with it; the <MODE, -1>
// instance runs only at k > 0.
__host__ __device__ constexpr bool slot_runs(int mode, int sk) {
  return mode != LMODE_NONE && sk != 0;
}

// ---------------------------------------------------------------------------
// matmul_O0: thread per column j of the one output row, which makes a round
// trip through device memory at every step (volatile: "-O0", no mem2reg).
// That round trip is what the region measures, and the loop runs at it (one
// L2 round trip a step); the run-time build's k > 0 test is taken once a
// call, on the host (slot_runs), not once an iteration.
// ---------------------------------------------------------------------------
template <bool SLOT, int MODE, int SK>
__device__ __forceinline__ void mm_o0_loop(volatile float* o, const float* __restrict__ a,
                                           const float* __restrict__ bj, int n, int n_iter,
                                           LoopNoise<MODE, SK>& nz, int k) {
  if constexpr (SLOT && SK < 0) __builtin_assume(k > 0);
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const int kk = (i * 8) % n;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int ku = min(kk + u, n - 1);   // lax.dynamic_slice clamps its start
      const float av = __ldg(a + ku);
      const float bv = __ldg(bj + (size_t)ku * n);
      *o = __fadd_rn(*o, __fmul_rn(av, bv));
    }
    if constexpr (SLOT) nz.emit(k, i);
  }
}

template <int MODE, int SK>
__global__ void __launch_bounds__(LOOP_THREADS)
mm_o0_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ out0, float* ob, int n, int n_iter, NoiseArgs na, int k,
             Reduce rd) {
  __shared__ float sh[LOOP_THREADS];
  constexpr bool SLOT = slot_runs(MODE, SK);
  const int j = blockIdx.x * LOOP_THREADS + threadIdx.x;
  LoopNoise<MODE, SK> nz;
  if constexpr (SLOT) nz.init(na, threadIdx.x & (LOOP_VEC - 1));
  float out = 0.f, aux = 0.f;
  if (j < n) {
    volatile float* o = ob + j;
    *o = out0[j];
    mm_o0_loop<SLOT>(o, a, b + j, n, n_iter, nz, k);
    // without the slot the loop leaves the carry alone: it is read after the
    // loop, so that it holds no register there (the clean build's loop)
    if constexpr (!SLOT) nz.init(na, threadIdx.x & (LOOP_VEC - 1));
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
  if constexpr (SK < 0) {
    if (k == 0) {   // the run-time build's k > 0 test, once a call
      mm_o0_kernel<MODE, 0><<<blocks, LOOP_THREADS, 0, st>>>(a, b, out0, ob, n, n_iter, na, 0,
                                                             rd);
      return cudaGetLastError();
    }
  }
  mm_o0_kernel<MODE, SK><<<blocks, LOOP_THREADS, 0, st>>>(a, b, out0, ob, n, n_iter, na, k, rd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matmul_O3: thread per column j, eight output rows in registers, fed by each
// loaded b row: acc[r] += a[r][kk] * b[kk][j], kk = i % n, in iteration
// order. Its floor is FP32 issue: 16 FADD/FMUL a thread and iteration (never
// contracted), one warp instruction a clock a scheduler, so 16 x n_iter x
// the warps of the busiest scheduler clocks. A loop that consumes its loads
// in the iteration that issues them instead waits one L2 round trip an
// iteration (~330 clocks). So:
// * a[:8, :n] is staged once a block into shared memory, transposed ((n +
//   MM_O3_AHEAD) x 8 floats, columns n, n + 1, ... copies of columns 0, 1,
//   ...; (MM_O3_MAX_N + MM_O3_AHEAD) x 32 bytes at most): an iteration's
//   eight a values are two 16-byte loads that every lane of the warp reads
//   at once, issued MM_O3_AHEAD iterations before the adds that take them;
// * b[kk][j] comes from a ring of MM_O3_RING loads in flight: iteration
//   i + MM_O3_RING's row is loaded while iteration i adds (a row past the
//   last iteration is loaded too, and never read: every row is in b);
// * the body runs in trips of MM_O3_UNROLL iterations, their stage and b
//   addresses at immediate offsets and one multiple of n from one base, while
//   neither kk nor the loaded row wraps inside the trip (checked once a
//   trip); an iteration across a wrap, and the last n_iter % MM_O3_UNROLL,
//   run one at a time;
// * the run-time build tests k > 0 once a call, on the host (slot_runs);
// * blocks of MM_O3_THREADS threads, one a block of the card's SMs: at the
//   main path's n = 192, three blocks of two warps, one warp a scheduler
//   (one block of 256 puts two warps on two of its SM's schedulers and ran
//   slower on the H100).
// With one warp a scheduler nothing hides a stall but the warp's own loads
// in flight, and ptxas's schedule of the trip sets how many it keeps: the
// loop runs well above its issue floor (PERF.md). The ring and the trips
// change when a value is loaded, never what is added or in what order: the
// plain version (ref.py matmul_o3_plain) is this arithmetic, its threads
// summed in blocks of MM_O3_THREADS.
// ---------------------------------------------------------------------------
#define MM_O3_ROWS 8
#define MM_O3_THREADS 64
#define MM_O3_UNROLL 8   // reference iterations a trip of the loop
#define MM_O3_RING 8
#define MM_O3_AHEAD 2   // iterations the stage reads run ahead
#define MM_O3_MAX_N 1024

// the eight rows' update from a's column kk (a[0..3][kk], a[4..7][kk]) and bv
__device__ __forceinline__ void mm_o3_step(float (&acc)[MM_O3_ROWS], float4 lo, float4 hi,
                                           float bv) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(lo.x, bv));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(lo.y, bv));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(lo.z, bv));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(lo.w, bv));
  acc[4] = __fadd_rn(acc[4], __fmul_rn(hi.x, bv));
  acc[5] = __fadd_rn(acc[5], __fmul_rn(hi.y, bv));
  acc[6] = __fadd_rn(acc[6], __fmul_rn(hi.z, bv));
  acc[7] = __fadd_rn(acc[7], __fmul_rn(hi.w, bv));
}

// One iteration's loads in flight, each a ring moved on by one an iteration
// (registers renamed in the unrolled trips): b's values MM_O3_RING
// iterations ahead, the stage's a columns MM_O3_AHEAD ahead.
struct O3Rings {
  float r[MM_O3_RING];
  float4 lo[MM_O3_AHEAD], hi[MM_O3_AHEAD];

  // the oldest iteration's b value and a column (bv, alo, ahi) out; row p's
  // b value and the stage column at s in
  __device__ __forceinline__ void next(float& bv, float4& alo, float4& ahi, const float* p,
                                       const float4* s) {
    bv = r[0];
    alo = lo[0];
    ahi = hi[0];
#pragma unroll
    for (int d = 0; d + 1 < MM_O3_RING; ++d) r[d] = r[d + 1];
#pragma unroll
    for (int d = 0; d + 1 < MM_O3_AHEAD; ++d) {
      lo[d] = lo[d + 1];
      hi[d] = hi[d + 1];
    }
    r[MM_O3_RING - 1] = __ldg(p);
    lo[MM_O3_AHEAD - 1] = s[0];
    hi[MM_O3_AHEAD - 1] = s[1];
  }
};

// Iterations 0 .. n_iter-1 of one thread (bj = b + j): c = i % n, l = (i +
// MM_O3_RING) % n, the row the next b load fetches. The stage's column c +
// MM_O3_AHEAD is read at iteration i (its columns n, n + 1, ... are copies
// of columns 0, 1, ..., so that read needs no wrap). SLOT: the noise an
// iteration, at its global index.
template <bool SLOT, int MODE, int SK>
__device__ __forceinline__ void mm_o3_loop(float (&acc)[MM_O3_ROWS], LoopNoise<MODE, SK>& nz,
                                           const float4* stage, const float* __restrict__ bj,
                                           int n, int n_iter, int k) {
  if constexpr (SLOT && SK < 0) __builtin_assume(k > 0);
  O3Rings g;
  int l = 0;
#pragma unroll
  for (int d = 0; d < MM_O3_RING; ++d) {
    g.r[d] = __ldg(bj + l * n);
    l = l + 1 == n ? 0 : l + 1;
  }
#pragma unroll
  for (int d = 0; d < MM_O3_AHEAD; ++d) {
    g.lo[d] = stage[2 * d];
    g.hi[d] = stage[2 * d + 1];
  }
  int c = 0, i = 0;
  float bv;
  float4 alo, ahi;
#pragma unroll 1
  while (i < n_iter) {
#pragma unroll 1
    while (i + MM_O3_UNROLL <= n_iter && c + MM_O3_UNROLL <= n && l + MM_O3_UNROLL <= n) {
      const float4* s = stage + 2 * (c + MM_O3_AHEAD);
      const float* q = bj + l * n;
#pragma unroll
      for (int u = 0; u < MM_O3_UNROLL; ++u) {
        g.next(bv, alo, ahi, q + u * n, s + 2 * u);
        mm_o3_step(acc, alo, ahi, bv);
        if constexpr (SLOT) nz.emit(k, i + u);
      }
      c += MM_O3_UNROLL;
      if (c == n) c = 0;
      l += MM_O3_UNROLL;
      if (l == n) l = 0;
      i += MM_O3_UNROLL;
    }
    if (i < n_iter) {
      g.next(bv, alo, ahi, bj + l * n, stage + 2 * (c + MM_O3_AHEAD));
      mm_o3_step(acc, alo, ahi, bv);
      if constexpr (SLOT) nz.emit(k, i);
      c = c + 1 == n ? 0 : c + 1;
      l = l + 1 == n ? 0 : l + 1;
      ++i;
    }
  }
}

template <int MODE, int SK>
__global__ void __launch_bounds__(MM_O3_THREADS)
mm_o3_kernel(const float* __restrict__ a, const float* __restrict__ b, int n, int n_iter,
             NoiseArgs na, int k, Reduce rd) {
  // a[0..3][kk], a[4..7][kk] at 2 kk, 2 kk + 1 for kk = 0 .. n +
  // MM_O3_AHEAD - 1; column n + d is column d's copy
  extern __shared__ float4 stage[];
  __shared__ float sh[MM_O3_THREADS];
  constexpr bool SLOT = slot_runs(MODE, SK);
  const int j = blockIdx.x * MM_O3_THREADS + threadIdx.x;
  LoopNoise<MODE, SK> nz;
  if constexpr (SLOT) nz.init(na, threadIdx.x & (LOOP_VEC - 1));
#pragma unroll 2
  for (int kk = threadIdx.x; kk < n + MM_O3_AHEAD; kk += MM_O3_THREADS) {
    const int col = kk < n ? kk : kk - n;
    float v[MM_O3_ROWS];
#pragma unroll
    for (int r = 0; r < MM_O3_ROWS; ++r) v[r] = __ldg(a + r * n + col);
    stage[2 * kk] = make_float4(v[0], v[1], v[2], v[3]);
    stage[2 * kk + 1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
  float out = 0.f, aux = 0.f;
  if (j < n) {
    float acc[MM_O3_ROWS];
#pragma unroll
    for (int r = 0; r < MM_O3_ROWS; ++r) acc[r] = 0.f;
    mm_o3_loop<SLOT>(acc, nz, stage, b + j, n, n_iter, k);
    // without the slot the loop leaves the carry alone: it is read after the
    // loop, so that it holds no register there (the clean build's loop)
    if constexpr (!SLOT) nz.init(na, threadIdx.x & (LOOP_VEC - 1));
    out = acc[0];
#pragma unroll
    for (int r = 1; r < MM_O3_ROWS; ++r) out = __fadd_rn(out, acc[r]);
    aux = nz.finalize();
  }
  reduce_blocks<MM_O3_THREADS>(out, aux, rd, sh);
}

// n outside [8, MM_O3_MAX_N] is refused (the wrapper refuses it first)
template <int MODE, int SK>
static cudaError_t launch_mm_o3(const float* a, const float* b, NoiseArgs na, Reduce rd, int n,
                                int n_iter, int k, cudaStream_t st) {
  if (n < MM_O3_ROWS || n > MM_O3_MAX_N) return cudaErrorInvalidValue;
  const int blocks = (n + MM_O3_THREADS - 1) / MM_O3_THREADS;
  const size_t stage = (size_t)(n + MM_O3_AHEAD) * MM_O3_ROWS * sizeof(float);
  if constexpr (SK < 0) {
    if (k == 0) {   // the run-time build's k > 0 test, once a call
      mm_o3_kernel<MODE, 0><<<blocks, MM_O3_THREADS, stage, st>>>(a, b, n, n_iter, na, 0, rd);
      return cudaGetLastError();
    }
  }
  mm_o3_kernel<MODE, SK><<<blocks, MM_O3_THREADS, stage, st>>>(a, b, n, n_iter, na, k, rd);
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
