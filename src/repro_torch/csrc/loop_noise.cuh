// Loop-body noise for Hopper: the device side of repro_torch/core/loopnoise.py,
// used by loop_regions.cu.
//
// The reference (src/repro/core/loopnoise.py) emits k patterns into the body
// of a lax.fori_loop that XLA compiles into one machine loop. Here each
// validation loop is one CUDA kernel and `LoopNoise<MODE, SK>::emit(k, i)`
// sits in its loop body where the reference calls noise.emit(carry, k, i),
// in the thread that ran the body, with i the loop's GLOBAL iteration index
// (so l1_ld / mem_ld offsets are the reference's).
//
// Carry: every thread keeps its own N_CHAINS = 4 accumulators of ONE lane
// (lane = thread index % 8) of the reference's 8-wide noise vector, so one
// pattern is one instruction a thread -- one warp-wide vector instruction,
// as one pattern is one AVX instruction on the paper's CPU. Pattern j goes
// to chain j % 4, as in the reference. finalize() gives the thread's
// ((a0 + a1) + a2) + a3 (chase: its index as a float); the region sums these
// over all threads in a fixed tree order (loop_regions.cu).
//
// Modes (one pattern each):
//   fp_add  acc = acc + c           __fadd_rn: without it, and with fast-math,
//                                   nvcc may fold k adds of the loop-invariant
//                                   c into one multiply
//   fp_fma  acc = fma(acc, 0.999999, c)   __fmaf_rn, one FFMA
//   l1_ld   acc += buf[(i*7 + j*13) % 512][lane]   16 KiB buffer, L1 hits:
//                                   a weak ld.global (SASS LDG.E, cached in
//                                   L1) in asm volatile, which keeps it. A
//                                   volatile C++ load would be
//                                   ld.volatile.global (LDG.E.STRONG.SYS),
//                                   and ld.global.ca becomes a strong load
//                                   (LDG.E.STRONG.SM); chip_smoke.py checks
//                                   the SASS.
//   mem_ld  acc += buf[((i*max(k,1) + j) * 40503) % rows][lane]   a buffer of
//                                   256 MiB on the card (5x the 50 MB L2):
//                                   ld.global.cg in asm volatile (L2 and
//                                   beyond, never L1)
//   chase   idx = table[idx]        serially dependent loads, 256 MiB table
// Offsets are the reference's traced int32 arithmetic: unsigned 32-bit
// products wrap as int32 does, and for the power-of-two row counts used
// (512; mem rows) masking the low bits is jnp's floor modulo of the wrapped
// value, also for a negative one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define LOOP_VEC 8
#define LOOP_L1_ROWS 512
#define LOOP_K_MAX 512

enum {
  LMODE_NONE = 0,
  LMODE_FP_ADD = 1,
  LMODE_FP_FMA = 2,
  LMODE_L1_LD = 3,
  LMODE_MEM_LD = 4,
  LMODE_CHASE = 5
};

// The noise carry as the wrapper hands it over (kernels/loop_regions/kernel.py)
struct NoiseArgs {
  const float* f;       // fp_add/fp_fma: c (8); l1_ld/mem_ld: buf (rows x 8)
  const float* acc0;    // the 4 x 8 initial accumulators
  const int* table;     // chase: the successor table
  const int* idx0;      // chase: the start index (one int)
  unsigned rows_mask;   // mem_ld: rows - 1 (rows a power of two)
};

__device__ __forceinline__ float ld_l1(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_l2_s32(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// SK >= 0: k is the static SK (fully unrolled patterns); SK < 0: run-time k
template <int MODE, int SK>
struct LoopNoise {
  float acc[4];
  float c;
  const float* buf;
  const int* table;
  unsigned mask;
  int lane;
  int idx;

  __device__ __forceinline__ void init(const NoiseArgs& na, int lane8) {
    lane = lane8;
    buf = na.f;
    table = na.table;
    mask = na.rows_mask;
    idx = 0;
    c = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = 0.f;
    if constexpr (MODE == LMODE_FP_ADD || MODE == LMODE_FP_FMA) c = na.f[lane8];
    if constexpr (MODE >= LMODE_FP_ADD && MODE <= LMODE_MEM_LD) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = na.acc0[r * LOOP_VEC + lane8];
    }
    if constexpr (MODE == LMODE_CHASE) idx = *na.idx0;
  }

  // pattern j of iteration i, into chain CH (= j % 4)
  template <int CH>
  __device__ __forceinline__ void pattern(int j, int i, int keff) {
    if constexpr (MODE == LMODE_FP_ADD) {
      acc[CH] = __fadd_rn(acc[CH], c);
    } else if constexpr (MODE == LMODE_FP_FMA) {
      acc[CH] = __fmaf_rn(acc[CH], 0.999999f, c);
    } else if constexpr (MODE == LMODE_L1_LD) {
      const unsigned off = ((unsigned)i * 7u + (unsigned)j * 13u) & (LOOP_L1_ROWS - 1);
      acc[CH] = __fadd_rn(acc[CH], ld_l1(buf + (size_t)off * LOOP_VEC + lane));
    } else if constexpr (MODE == LMODE_MEM_LD) {
      const unsigned off = (((unsigned)i * (unsigned)keff + (unsigned)j) * 40503u) & mask;
      acc[CH] = __fadd_rn(acc[CH], ld_l2(buf + (size_t)off * LOOP_VEC + lane));
    } else if constexpr (MODE == LMODE_CHASE) {
      idx = ld_l2_s32(table + idx);
    }
  }

  // k patterns at iteration i; pattern j does the same arithmetic in the
  // static and the run-time build, four at a time so that the chain index
  // is a constant (no local-memory array)
  __device__ __forceinline__ void emit(int k, int i) {
    if constexpr (MODE != LMODE_NONE) {
      if constexpr (SK >= 0) {
        constexpr int keff = SK > 1 ? SK : 1;
#pragma unroll
        for (int j = 0; j < SK; j += 4) {
          pattern<0>(j, i, keff);
          if (j + 1 < SK) pattern<1>(j + 1, i, keff);
          if (j + 2 < SK) pattern<2>(j + 2, i, keff);
          if (j + 3 < SK) pattern<3>(j + 3, i, keff);
        }
      } else if (k > 0) {
        // the guard is one uniform branch: ptxas predicates the remainder
        // below (its instructions issue whatever k is), so without it a
        // k=0 call would still pay for three patterns' address arithmetic
        const int keff = k > 1 ? k : 1;
        int j = 0;
        for (; j + 4 <= k; j += 4) {
          pattern<0>(j, i, keff);
          pattern<1>(j + 1, i, keff);
          pattern<2>(j + 2, i, keff);
          pattern<3>(j + 3, i, keff);
        }
        if (j < k) pattern<0>(j, i, keff);
        if (j + 1 < k) pattern<1>(j + 1, i, keff);
        if (j + 2 < k) pattern<2>(j + 2, i, keff);
      }
    }
  }

  __device__ __forceinline__ float finalize() const {
    if constexpr (MODE == LMODE_NONE) {
      return 0.f;
    } else if constexpr (MODE == LMODE_CHASE) {
      return __int2float_rn(idx);
    } else {
      return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
    }
  }
};

// Sum v over the NT threads of the block: sh[t] += sh[t + s] for s = NT/2,
// NT/4, ..., 1 (kernels/loop_regions/ref.py `tree_sum` is this order).
// Every thread of the block must call it; it returns the sum to all.
template <int NT>
__device__ __forceinline__ float block_tree_sum(float v, float* sh) {
  const int t = threadIdx.x;
  __syncthreads();   // a previous call's readers of sh[0] are done
  sh[t] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = __fadd_rn(sh[t], sh[t + s]);
    __syncthreads();
  }
  return sh[0];
}

static inline int loop_clip_k(int k) { return k < 0 ? 0 : (k > LOOP_K_MAX ? LOOP_K_MAX : k); }

// Call f(std::integral_constant<int, MODE>{}) for a run-time mode id.
template <typename F>
static inline int dispatch_mode(int mode, F&& f) {
  switch (mode) {
    case LMODE_NONE: return (int)f(std::integral_constant<int, LMODE_NONE>{});
    case LMODE_FP_ADD: return (int)f(std::integral_constant<int, LMODE_FP_ADD>{});
    case LMODE_FP_FMA: return (int)f(std::integral_constant<int, LMODE_FP_FMA>{});
    case LMODE_L1_LD: return (int)f(std::integral_constant<int, LMODE_L1_LD>{});
    case LMODE_MEM_LD: return (int)f(std::integral_constant<int, LMODE_MEM_LD>{});
    case LMODE_CHASE: return (int)f(std::integral_constant<int, LMODE_CHASE>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
