// The paper's DECAN loops (its Table 3 and Fig. 6) as CUDA kernels for
// Hopper (sm_90a), with the FP / LS removal variants compiled apart and a
// loop-body noise slot (loop_noise.cuh) in the reference variant.
//
// Replaces: benchmarks/table3_decan.py:46 `_kernel` and
// benchmarks/fig6_overlap.py:27 `_livermore`, which are no Pallas kernels
// but XLA loops (one jax.jit of a lax.fori_loop each, the variants removed
// at trace time). As a Python loop of PyTorch operations each iteration
// would be tens of launches, and launch gaps would hide both the removal and
// any injected noise. So each loop is one kernel a call (one launch: the
// blocks sum in the kernel's own epilogue, reduce_blocks), and a variant is
// a template instance <FP, LS>: removal at compile time, as the reference
// removes at trace time. A variant keeps the control flow and the trip
// count; what it keeps feeds its output (the chains' sums, the loads'
// accumulators) or a buffer the caller never reads (the triad's `cout`), so
// no compiler can delete the class a variant keeps.
//
//   t3_kernel<KIND>   Table 3's scenario loop (4 chains of y = y + y*y*1e-9,
//                     `depth` steps an iteration, __fmul_rn / __fadd_rn so
//                     nothing contracts into FFMA):
//     token        (compute-bound)  two 8-wide loads an iteration from a
//                  4096-float window (L1-resident) into accs[0..1]
//     stream       (data-bound, full-overlap) a 512-float triad chunk an
//                  iteration, cout = a + 3 b: triad.cuh's chunk, as
//                  STREAM's in loop_regions.cu (what held the old loop back
//                  and what the routine does about it are noted there), its
//                  offset stepped (the old loop's integer modulo an
//                  iteration is gone); bound by device memory when N = 2^25
//                  (a, b, cout: 384 MiB, far beyond the 50 MB L2), where
//                  the chains must hide under the loads (Table 3's full
//                  overlap)
//     scatter_dep  (limited-overlap) four 8-wide loads at
//                  ((i*4+j)*40503) % (N-8) an iteration, seeding the chains
//                  (seed = acc*1e-12 + x): dependent misses
//   liv_kernel        Fig. 6's Livermore loop: 12 add chains and one light
//                     8-wide load (a 1 MiB buffer, cache-resident) an
//                     iteration, its offset stepped (no modulo); bound by
//                     FP32 issue. The paper's out-of-order core overlaps the
//                     light load with the chains in hardware; an SM issues
//                     in order, and a load consumed in the iteration that
//                     issued it leaves the warp waiting one L2 round trip
//                     (~300 cycles) an iteration. So the loop does in
//                     software what that core does: a ring of LIV_RING
//                     loads in flight (the load of iteration i + LIV_RING
//                     issued while iteration i adds its value), the body
//                     unrolled LIV_UNROLL times with immediate offsets where
//                     no wrap falls in the trip (checked once a trip), and
//                     the noise slot's run-time k > 0 test taken once a
//                     call (a body with the slot and one without).
//
// Mapping of the reference's sequential 8-lane loop onto the card, as in
// loop_regions.cu: a group of 8 threads holds the reference's 8 lanes.
// * stream: the chunks are independent, so warps walk the iterations
//   grid-stride (`groups` warps); each warp's lanes 0..7 carry one
//   reference state (chains) across the iterations the warp runs; lanes
//   8..31 run the same chains (free on SIMT) and add nothing to the output;
// * token, scatter_dep, livermore: the state is loop-carried, so every group
//   of 8 threads runs every iteration in order (`groups` = width / 8
//   copies). scatter_dep's group g loads from the address stream of
//   iterations i + g*n_iter, so the groups miss on different lines: with
//   one stream for all, the first group would bring each line into the L2
//   for the others. Group 0's stream is the reference's. Livermore's ring
//   changes when a load is issued, not what is added: every iteration
//   reads the reference's address once, and its value is added to the
//   accumulator in the reference's order, one add an iteration.
// One group (width 8, or one warp for stream) is the reference's loop. Each
// thread keeps its noise carry (lane = thread % 8) and emits k patterns an
// iteration it runs. The output is the sum over the groups of the
// reference's output terms: a thread's ((a0+a1)+a2)+a3 + ((x0+x1)+x2)+x3
// (Livermore: its 12 chains, then its load accumulator), summed by block
// trees and the last block (reduce_blocks), which then adds sum(cb[:8]):
// the triad buffer's first 8 values when the stream LS part ran, else c's.
// kernels/decan_loops/ref.py is that order in plain PyTorch.
//
// Offsets are the reference's traced int32 arithmetic: products wrap at 32
// bits, then jnp's floor modulo (the stream scenarios' is stepped, which
// equals it where n_iter * 512 < 2^31; the wrapper refuses the rest).
#include "loop_noise.cuh"   // LoopNoise, reduce_blocks
#include "triad.cuh"        // Triad512

#define DL_THREADS 256
#define DL_WARPS (DL_THREADS / 32)
#define T3_CHUNK TRIAD_CHUNK
#define T3_WINDOW 4096
#define LIV_CHUNK 64
#define LIV_CHAINS 12
#define LIV_UNROLL 8   // reference iterations a trip of the loop
// light loads in flight a thread: 8 warps a scheduler at ~15 instructions
// an iteration make 8 iterations ~1,000 cycles, past an L2 round trip under
// load (a ring of 4 covers it too, and ran ~1% slower on the H100)
#define LIV_RING 8

enum { KIND_TOKEN = 0, KIND_STREAM = 1, KIND_SCATTER_DEP = 2 };

__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int floor_mod(int v, int m) {
  const int r = v % m;
  return r < 0 ? r + m : r;
}

// the four chains, `depth` steps: y = y + (y*y)*1e-9
__device__ __forceinline__ void t3_chains(float (&x)[4], int depth) {
#pragma unroll 2
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __fadd_rn(x[j], __fmul_rn(__fmul_rn(x[j], x[j]), 1e-9f));
  }
}

__device__ __forceinline__ float sum4(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
}

// sum(cb[:8]) from 0, in order (cb written in this launch: through L2)
__device__ __forceinline__ float first8(const float* cb) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s = __fadd_rn(s, ld_coherent_f32(cb + e));
  return s;
}

struct T3 {
  const float* a;
  const float* b;
  const float* c;
  const float* x0;   // the reference's 8 lanes
  float* cout;       // the triad's (dead) buffer
  int n, n_iter, depth, groups;
};

// ---------------------------------------------------------------------------
// Table 3's scenario loop
// ---------------------------------------------------------------------------
template <int KIND, bool FP, bool LS, int MODE, int SK>
__global__ void __launch_bounds__(DL_THREADS) t3_kernel(T3 p, NoiseArgs na, int k, Reduce rd) {
  __shared__ float sh[DL_THREADS];
  constexpr bool STREAM = KIND == KIND_STREAM;
  const int t = blockIdx.x * DL_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int unit = STREAM ? t >> 5 : t >> 3;   // the thread's warp or lane group
  const int l8 = t & 7;
  const bool active = unit < p.groups;
  LoopNoise<MODE, SK> nz;
  nz.init(na, l8);
  float out = 0.f, aux = 0.f;
  if (active) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, xs[4];
    const float x0 = p.x0[l8];
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[j] = __fadd_rn(x0, (float)j);
    if constexpr (STREAM) {
      // the triad at (i*512) % m, m = n - 512, stepped: off starts at
      // (unit*512) % m and each grid-stride step adds (groups*512) % m and
      // takes m off once it reaches m (the wrapper keeps n_iter*512 below
      // 2^31, where this is the reference's int32 floor modulo); no
      // integer division in the loop, which the card does in software
      const unsigned m = (unsigned)(p.n - T3_CHUNK);
      unsigned off = 0, step = 0;
      Triad512 tri;
      if constexpr (LS) {
        off = (unsigned)(((unsigned long long)unit * T3_CHUNK) % m);
        step = (unsigned)(((unsigned long long)p.groups * T3_CHUNK) % m);
        if (unit < p.n_iter) tri.load(p.a, p.b, off, lane);
      }
#pragma unroll 1
      for (int i = unit; i < p.n_iter; i += p.groups) {
        if constexpr (LS) {
          const unsigned next = off + step >= m ? off + step - m : off + step;
          tri.advance(p.a, p.b, p.cout, off, next, i < p.n_iter - p.groups, lane);
          off = next;
        }
        if constexpr (FP) t3_chains(xs, p.depth);
        nz.emit(k, i);
      }
    } else {
      const int g = unit;
#pragma unroll 1
      for (int i = 0; i < p.n_iter; ++i) {
        if constexpr (LS && KIND == KIND_TOKEN) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int off = floor_mod(wrap_mul(wrap_add(wrap_mul(i, 2), j), 16), T3_WINDOW);
            acc[j] = __fadd_rn(acc[j], __ldg(p.a + off + l8));
          }
        }
        if constexpr (LS && KIND == KIND_SCATTER_DEP) {
          const int ig = wrap_add(i, wrap_mul(g, p.n_iter));
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int off = floor_mod(wrap_mul(wrap_add(wrap_mul(ig, 4), j), 40503), p.n - 8);
            v[j] = __ldg(p.a + off + l8);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
        }
        if constexpr (FP) {
          if constexpr (KIND == KIND_SCATTER_DEP && LS) {
#pragma unroll
            for (int j = 0; j < 4; ++j) xs[j] = __fadd_rn(__fmul_rn(acc[j], 1e-12f), xs[j]);
          }
          t3_chains(xs, p.depth);
        }
        nz.emit(k, i);
      }
    }
    if (!STREAM || lane < 8) out = __fadd_rn(sum4(acc), sum4(xs));
    aux = nz.finalize();
  }
  if (reduce_blocks<DL_THREADS>(out, aux, rd, sh) && threadIdx.x == 0) {
    const float* cb = (STREAM && LS && p.n_iter > 0) ? p.cout : p.c;
    rd.res[0] = __fadd_rn(first8(cb), rd.res[0]);
  }
}

// ---------------------------------------------------------------------------
// Fig. 6's Livermore loop: every group of 8 threads runs every iteration
// ---------------------------------------------------------------------------
// The state of one thread's loop: the chains, the load accumulator, the
// ring (r[d] holds the value of iteration i + d) and the offset `lo` of the
// next load, (j*64) % (n-64) for iteration j = i + LIV_RING, stepped: the
// card has no integer divider, and a modulo an iteration would be the
// loop's heaviest work, where the reference's load is light (the wrapper
// keeps n_iter*64 below 2^31). Between loads lo may reach m = n - 64; a
// stepped load takes m off first.
template <bool FP, bool LS>
struct LivState {
  float ch[LIV_CHAINS];
  float acc;
  float r[LIV_RING];
  int lo;

  // iteration i's value into the accumulator and the ring moved on by one
  // (registers renamed in the unrolled trips); the caller then loads the
  // ring's newest entry, r[LIV_RING - 1], for iteration i + LIV_RING
  __device__ __forceinline__ void consume() {
    if constexpr (LS) {
      acc = __fadd_rn(acc, r[0]);
#pragma unroll
      for (int d = 0; d + 1 < LIV_RING; ++d) r[d] = r[d + 1];
    }
  }

  __device__ __forceinline__ void chains() {
    if constexpr (FP) {
#pragma unroll
      for (int j = 0; j < LIV_CHAINS; ++j) ch[j] = __fadd_rn(ch[j], 1e-7f);
    }
  }

  // the next load at its stepped offset
  __device__ __forceinline__ float load_stepped(const float* p, int m) {
    if (lo >= m) lo -= m;
    const float v = __ldg(p + lo);
    lo += LIV_CHUNK;
    return v;
  }
};

// Iterations 0 .. n_iter-1 of one thread (p = buf + lane). Trips of
// LIV_UNROLL iterations run while each of their loads exists (i + U + RING
// <= n_iter): a trip whose loads lie before the wrap (lo + (U-1)*64 < m,
// checked once a trip) takes them at immediate offsets from one address
// and steps lo once, in the innermost loop; the trip across the wrap steps
// each load. The last < U + RING iterations consume the ring and load
// while iteration i + RING exists. SLOT: emit the noise an iteration, at
// its global index (the run-time build at k = 0 runs the body without it).
template <bool FP, bool LS, bool SLOT, int MODE, int SK>
__device__ __forceinline__ void liv_loop(LivState<FP, LS>& s, LoopNoise<MODE, SK>& nz,
                                         const float* __restrict__ p, int m, int n_iter, int k) {
  if constexpr (SLOT && SK < 0) __builtin_assume(k > 0);
  s.lo = 0;
#pragma unroll
  for (int d = 0; d < LIV_RING; ++d) {
    s.r[d] = 0.f;
    if constexpr (LS) {
      if (d < n_iter) s.r[d] = s.load_stepped(p, m);
    }
  }
  const int last_trip = n_iter - LIV_RING - LIV_UNROLL;   // a trip starts at i <= it
  int i = 0;
#pragma unroll 1
  while (i <= last_trip) {
#pragma unroll 1
    while (i <= last_trip && (!LS || s.lo + (LIV_UNROLL - 1) * LIV_CHUNK < m)) {
      const float* q = p + s.lo;
#pragma unroll
      for (int u = 0; u < LIV_UNROLL; ++u) {
        s.consume();
        if constexpr (LS) s.r[LIV_RING - 1] = __ldg(q + u * LIV_CHUNK);
        s.chains();
        if constexpr (SLOT) nz.emit(k, i + u);
      }
      if constexpr (LS) s.lo += LIV_UNROLL * LIV_CHUNK;
      i += LIV_UNROLL;
    }
    if (i <= last_trip) {
#pragma unroll
      for (int u = 0; u < LIV_UNROLL; ++u) {
        s.consume();
        if constexpr (LS) s.r[LIV_RING - 1] = s.load_stepped(p, m);
        s.chains();
        if constexpr (SLOT) nz.emit(k, i + u);
      }
      i += LIV_UNROLL;
    }
  }
#pragma unroll 1
  for (; i < n_iter; ++i) {
    s.consume();
    if constexpr (LS) {
      if (i + LIV_RING < n_iter) s.r[LIV_RING - 1] = s.load_stepped(p, m);
    }
    s.chains();
    if constexpr (SLOT) nz.emit(k, i);
  }
}

// 4 blocks of 256 an SM: at most 64 registers a thread, so the main path's
// 528 blocks run in one wave
template <bool FP, bool LS, int MODE, int SK>
__global__ void __launch_bounds__(DL_THREADS, 4)
liv_kernel(const float* __restrict__ buf, int n, int n_iter, int width, NoiseArgs na, int k,
           Reduce rd) {
  __shared__ float sh[DL_THREADS];
  const int t = blockIdx.x * DL_THREADS + threadIdx.x;
  const int l8 = t & 7;
  LoopNoise<MODE, SK> nz;
  nz.init(na, l8);
  float out = 0.f, aux = 0.f;
  if (t < width) {
    LivState<FP, LS> s;
    s.acc = 0.f;
#pragma unroll
    for (int j = 0; j < LIV_CHAINS; ++j) s.ch[j] = (float)j;
    const float* p = buf + l8;
    const int m = n - LIV_CHUNK;
    if constexpr (MODE == LMODE_NONE || SK == 0) {
      liv_loop<FP, LS, false>(s, nz, p, m, n_iter, k);
    } else if constexpr (SK > 0) {
      liv_loop<FP, LS, true>(s, nz, p, m, n_iter, k);
    } else if (k > 0) {       // one test a call, not one an iteration
      liv_loop<FP, LS, true>(s, nz, p, m, n_iter, k);
    } else {
      liv_loop<FP, LS, false>(s, nz, p, m, n_iter, k);
    }
    out = s.ch[0];
#pragma unroll
    for (int j = 1; j < LIV_CHAINS; ++j) out = __fadd_rn(out, s.ch[j]);
    out = __fadd_rn(out, s.acc);
    aux = nz.finalize();
  }
  reduce_blocks<DL_THREADS>(out, aux, rd, sh);
}

template <int KIND, bool FP, bool LS, int MODE, int SK>
static cudaError_t launch_t3(const T3& p, NoiseArgs na, Reduce rd, int width, int k,
                             cudaStream_t st) {
  const int threads = KIND == KIND_STREAM ? 32 * p.groups : width;
  const int blocks = (threads + DL_THREADS - 1) / DL_THREADS;
  t3_kernel<KIND, FP, LS, MODE, SK><<<blocks, DL_THREADS, 0, st>>>(p, na, k, rd);
  return cudaGetLastError();
}

template <int KIND, int MODE, int SK>
static cudaError_t dispatch_t3(const T3& p, NoiseArgs na, Reduce rd, int width, int fp, int ls,
                               int k, cudaStream_t st) {
  if (fp && ls) return launch_t3<KIND, true, true, MODE, SK>(p, na, rd, width, k, st);
  if constexpr (MODE == LMODE_NONE) {   // the DECAN variants run without noise
    if (fp) return launch_t3<KIND, true, false, MODE, SK>(p, na, rd, width, k, st);
    if (ls) return launch_t3<KIND, false, true, MODE, SK>(p, na, rd, width, k, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int SK>
static cudaError_t run_t3(const T3& p, NoiseArgs na, Reduce rd, int width, int kind, int fp,
                          int ls, int k, cudaStream_t st) {
  switch (kind) {
    case KIND_TOKEN: return dispatch_t3<KIND_TOKEN, MODE, SK>(p, na, rd, width, fp, ls, k, st);
    case KIND_STREAM: return dispatch_t3<KIND_STREAM, MODE, SK>(p, na, rd, width, fp, ls, k, st);
    case KIND_SCATTER_DEP:
      return dispatch_t3<KIND_SCATTER_DEP, MODE, SK>(p, na, rd, width, fp, ls, k, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FP, bool LS, int MODE, int SK>
static cudaError_t launch_liv(const float* buf, NoiseArgs na, Reduce rd, int n, int n_iter,
                              int width, int k, cudaStream_t st) {
  const int blocks = (width + DL_THREADS - 1) / DL_THREADS;
  liv_kernel<FP, LS, MODE, SK><<<blocks, DL_THREADS, 0, st>>>(buf, n, n_iter, width, na, k, rd);
  return cudaGetLastError();
}

template <int MODE, int SK>
static cudaError_t run_liv(const float* buf, NoiseArgs na, Reduce rd, int n, int n_iter, int width,
                           int fp, int ls, int k, cudaStream_t st) {
  if (fp && ls) return launch_liv<true, true, MODE, SK>(buf, na, rd, n, n_iter, width, k, st);
  if constexpr (MODE == LMODE_NONE) {
    if (fp) return launch_liv<true, false, MODE, SK>(buf, na, rd, n, n_iter, width, k, st);
    if (ls) return launch_liv<false, true, MODE, SK>(buf, na, rd, n, n_iter, width, k, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// C entries: the loop's tensors, the four noise operands (nf, nacc0, ntab,
// nidx0; loop_regions.cu's), then parts, the ticket counter and res (2
// floats: [output, aux]); the ints end with fp, ls and rows_mask. The
// run-time library's repro_<loop>_rt(..., mode, k, stream) has every
// variant without noise and the reference variant (fp = ls = 1) under every
// mode; a static build (-DREPRO_STATIC_MODE, -DREPRO_STATIC_K) has
// repro_<loop>_static(..., stream), the reference variant at its (mode, k).
// ---------------------------------------------------------------------------
#define NOISE_PARAMS const float *nf, const float *nacc0, const int *ntab, const int *nidx0
#define NOISE_ARGS NoiseArgs{nf, nacc0, ntab, nidx0, (unsigned)rows_mask}
#define REDUCE_PARAMS float *parts, unsigned *counter, float *res
#define RD Reduce{parts, counter, res}
#define T3_PARAMS                                                                            \
  const float *a, const float *b, const float *c, const float *x0, float *cout, NOISE_PARAMS, \
      REDUCE_PARAMS, int n, int n_iter, int depth, int groups, int width, int kind, int fp,  \
      int ls, int rows_mask
#define T3_ARGS T3{a, b, c, x0, cout, n, n_iter, depth, groups}
#define LIV_PARAMS \
  const float *buf, NOISE_PARAMS, REDUCE_PARAMS, int n, int n_iter, int width, int fp, int ls, int rows_mask

#ifdef REPRO_STATIC_K
extern "C" int repro_t3_static(T3_PARAMS, void* stream) {
  if (!(fp && ls)) return (int)cudaErrorInvalidValue;
  return (int)run_t3<REPRO_STATIC_MODE, REPRO_STATIC_K>(T3_ARGS, NOISE_ARGS, RD, width, kind, 1, 1,
                                                       REPRO_STATIC_K, (cudaStream_t)stream);
}

extern "C" int repro_liv_static(LIV_PARAMS, void* stream) {
  if (!(fp && ls)) return (int)cudaErrorInvalidValue;
  return (int)run_liv<REPRO_STATIC_MODE, REPRO_STATIC_K>(buf, NOISE_ARGS, RD, n, n_iter, width, 1,
                                                        1, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_t3_rt(T3_PARAMS, int mode, int k_in, void* stream) {
  const int k = loop_clip_k(k_in);
  return dispatch_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    return run_t3<MODE, -1>(T3_ARGS, NOISE_ARGS, RD, width, kind, fp, ls, k, (cudaStream_t)stream);
  });
}

extern "C" int repro_liv_rt(LIV_PARAMS, int mode, int k_in, void* stream) {
  const int k = loop_clip_k(k_in);
  return dispatch_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    return run_liv<MODE, -1>(buf, NOISE_ARGS, RD, n, n_iter, width, fp, ls, k,
                             (cudaStream_t)stream);
  });
}
#endif
