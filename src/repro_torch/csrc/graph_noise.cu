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
//                     repeated load must not be merged). One LDS a pattern,
//                     8 warps x 128 B on each of four SMs: 8 clocks a
//                     pattern at 128 B a clock. The rows the patterns read
//                     are staged by one bulk copy on an mbarrier, overlapped
//                     with the accumulators' loads, and only when k > 0;
//                     each thread keeps a ring of G_VMEM_RING loads in
//                     flight, each slot's offset stepped (+ (13 R) % m,
//                     wrapped once: the card has no integer divider, and
//                     a modulo a pattern costs more than the load).
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
// aux: the f32 modes sum their state in the kernel's own epilogue: a tree
// over each block's 256 threads, then the block sums in order
// (kernels/graph_noise/ref.py follows that order, so the card's aux is
// bitwise its plain version's). fp_add32 and vmem_ld launch their blocks
// (at most G_CLUSTER_MAX) as one thread-block cluster, each block stores
// its sum into rank 0's shared memory with st.async on rank 0's mbarrier,
// and rank 0 adds them (cluster_aux); fp_add32's larger grids and
// hbm_stream take reduce_blocks (loop_noise.cuh), whose last block to take
// a ticket adds them.
// fp_add32 and vmem_ld report 0 at static k = 0, as the reference's `apply`
// does; their run-time k = 0 sums the carried accumulators, as `apply_rt`.
// States are written out of place: the inputs stay as they were (the
// reference's functional semantics).
#include <cuda_bf16.h>

#include <utility>   // std::forward

#include "hopper.cuh"       // wgmma (bf16, B MN-major), its descriptor, fences
#include "loop_noise.cuh"   // block_tree_sum, Reduce, reduce_blocks, ld_l2, ld_l2_s32

#define G_THREADS 256
#define MXU_D 128
#define MXU_LD 136   // the final m's row stride in bf16 elements: 272 bytes, so
                     // a warp's fragment stores of 8 rows hit 32 banks
#define G_STREAM_RING 16   // hbm_stream's loads in flight a thread
#define G_VMEM_RING 8      // vmem_ld's loads in flight a thread (a multiple of 4)
#define G_CLUSTER_MAX 8    // the most blocks of one cluster (the portable size)
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
// the cluster epilogue of fp_add32 and vmem_ld
// ---------------------------------------------------------------------------
// The sum of v over the block's 256 threads in block_tree_sum's order
// (sh[t] += sh[t + s] for s = 128, 64, ..., 1) behind one barrier: lane t
// of warp 0 adds the first three levels' eight values of its column
// straight from shared memory, then the last five levels by shuffles. The
// sum is warp 0's lane 0's.
__device__ __forceinline__ float warp0_tree_sum(float v, float* sh) {
  static_assert(G_THREADS == 256, "the first three levels are those of 256 threads");
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  float s = 0.f;
  if (t < 32) {
    const float a = __fadd_rn(__fadd_rn(sh[t], sh[t + 128]), __fadd_rn(sh[t + 64], sh[t + 192]));
    const float b = __fadd_rn(__fadd_rn(sh[t + 32], sh[t + 160]), __fadd_rn(sh[t + 96], sh[t + 224]));
    s = __fadd_rn(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
  }
  return s;
}

// The aux of a launch of gridDim.x <= G_CLUSTER_MAX blocks as one cluster
// into res = {0, aux}, with no fence and no block waiting on another but
// rank 0: at the kernel's start rank 0 arms an mbarrier for the other
// C - 1 block sums' 4 bytes each and every thread arrives (relaxed) at the
// cluster barrier that publishes its initialisation (cluster_aux_arm); at
// the end thread 0 of each other block waits on that barrier (long
// complete by then) and stores its tree sum into rank 0's `csum` with
// st.async, which completes on rank 0's mbarrier (st.async writes a peer
// block's memory: rank 0 keeps its own sum in a register), and rank 0
// adds them in reduce_blocks' order. (A cluster.sync() releases at
// cluster scope, which ptxas makes a MEMBAR.ALL.GPU that waits for the
// block's global stores: 0.23-0.25 us more a call on the H100.)
// reduce_blocks' last block has thread t < C hold 0 + s_t (never -0) and
// the others +0, and its 256-thread tree adds +0 to each value until the
// last three levels: the sum is lanes 0..7's over those levels (ref.py's
// mirror is held to reduce_threads on the CPU).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the shared::cluster address of `a` (this block's shared memory) in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(const void* a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(a)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_aux_arm(uint64_t* cbar) {
  if (cluster_rank() == 0 && threadIdx.x == 0) {
    mbar_init(cbar, 1);
    if (gridDim.x > 1)
      mbar_expect_tx(cbar, 4u * (gridDim.x - 1));   // rank 0 keeps its own sum
    else
      mbar_arrive(cbar);
    fence_barrier_init();
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_aux(float v, float* res, float* sh, float* csum,
                                            uint64_t* cbar) {
  const float s = warp0_tree_sum(v, sh);
  const uint32_t rank = cluster_rank();
  if (rank != 0 && threadIdx.x == 0) {   // st.async writes another block's memory
    asm volatile("barrier.cluster.wait;" ::: "memory");   // rank 0's cbar is armed
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
            map_rank(csum + rank, 0)),
        "r"(__float_as_uint(s)), "r"(map_rank(cbar, 0))
        : "memory");
  }
  if (rank == 0 && threadIdx.x < 32) {
    const uint32_t a_bar = smem_u32(cbar);
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a_bar)
          : "memory");
      if (polls == (1u << 26)) __trap();   // as mbar_wait: a fault, not a hang
    }
    const int t = threadIdx.x;
    float a = t == 0 ? __fadd_rn(0.f, s) : (t < (int)gridDim.x ? __fadd_rn(0.f, csum[t]) : 0.f);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, o));
    if (t == 0) {
      res[0] = 0.f;
      res[1] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// fp_add32: a thread an element of the (rows,128) tiles
// ---------------------------------------------------------------------------
// `cluster` (uniform): the blocks are one cluster (cluster_aux), else the
// grid's last block sums them (reduce_blocks). The static k = 0 build
// reports aux 0, as the reference's `apply` does, and sums nothing.
template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gfp_kernel(const float* __restrict__ c, Accs ac, int E, int ici, int k, int cluster, Reduce rd) {
  __shared__ float sh[G_THREADS];
  __shared__ float csum[G_CLUSTER_MAX];
  __shared__ __align__(8) uint64_t cbar;
  const int e = blockIdx.x * G_THREADS + threadIdx.x;
  if (SK != 0 && cluster) cluster_aux_arm(&cbar);
  float v = 0.f;
  if (e < E) {
    const float ce = ici ? __fmul_rn(__ldg(c + e), 1e-3f) : __ldg(c + e);   // ici: v[:128] * 1e-3
    float acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = __ldg(ac.in[r] + e);
    round_robin<SK>(k, [&](auto ch, int) {
      acc[decltype(ch)::value] = __fadd_rn(acc[decltype(ch)::value], ce);
    });
#pragma unroll
    for (int r = 0; r < 4; ++r) ac.out[(size_t)r * E + e] = acc[r];
    v = chains_sum(acc);
  }
  if constexpr (SK == 0) {
    if (e == 0) rd.res[0] = rd.res[1] = 0.f;
  } else if (cluster) {
    cluster_aux(v, rd.res, sh, csum, &cbar);
  } else {
    reduce_blocks<G_THREADS>(0.f, v, rd, sh);
  }
}

// ---------------------------------------------------------------------------
// vmem_ld: a thread an element of the (8,128) accumulators, buf in shared
// ---------------------------------------------------------------------------
// The rows of buf that k >= 1 patterns read: offsets up to min(13 (k - 1),
// m - 1), 8 rows from each
__host__ __device__ __forceinline__ int vmem_stage_rows(int rows, int k) {
  const int m = rows - 8 > 1 ? rows - 8 : 1;
  return (13 * (k - 1) < m - 1 ? 13 * (k - 1) : m - 1) + 8;
}

// 4 bytes of shared memory at `a`, a load of its own (never merged with
// another of the same address)
__device__ __forceinline__ float lds_volatile(uint32_t a) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// The k patterns into the four chains: pattern j adds the element `at` +
// off_j * 512 bytes, off_j = (j*13) % m, into acc[j % 4]. Ring slot i
// holds patterns i, i + R, ...: its offset starts at (13 i) % m and steps
// by (13 R) % m, wrapped once (R independent chains of an add and a min,
// not one serial chain and not a modulo a pattern). Pattern j + R's load is issued
// where pattern j is added, after the add, into the register the add read:
// full trips of R patterns while two trips remain, then the last < 2R
// patterns take the ring's remaining loads (stream_patterns' schedule). R
// is a multiple of 4, so ring slot i feeds chain i % 4.
template <int SK>
__device__ __forceinline__ void vmem_patterns(uint32_t at, int m, int k, float (&acc)[4]) {
  constexpr int R = G_VMEM_RING;
  static_assert(R % 4 == 0, "ring slot i feeds chain i % 4");
  const uint32_t wrap = (uint32_t)m * 512u;
  uint32_t o[R];   // o[i]: the byte offset of slot i's next load
  {
    const uint32_t s1 = (uint32_t)(13 % m) * 512u;
    uint32_t off = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      o[i] = off;
      off += s1;
      if (off >= wrap) off -= wrap;
    }
  }
  // o + step, less wrap where that reaches wrap: the smaller of o + step
  // and o + step - wrap as unsigned (below wrap the second wraps around)
  const uint32_t step = (uint32_t)((13 * R) % m) * 512u, back = step - wrap;
  auto next = [&](int i) {
    const float v = lds_volatile(at + o[i]);
    o[i] = min(o[i] + step, o[i] + back);
    return v;
  };
  float r[R];   // r[i]: pattern j + i
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = i < k ? next(i) : 0.f;
  auto trip = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i & 3] = __fadd_rn(acc[i & 3], r[i]);
      r[i] = next(i);   // pattern j + R + i
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
      acc[i & 3] = __fadd_rn(acc[i & 3], r[i]);
      if (j + R + i < k) r[i] = next(i);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (j + R + i < k) acc[i & 3] = __fadd_rn(acc[i & 3], r[i]);
}

// Four blocks, one cluster. Thread 0 starts the bulk copy of the rows the
// patterns read, then every thread loads its accumulators while it lands.
template <int SK>
__global__ void __launch_bounds__(G_THREADS)
gvmem_kernel(const float* __restrict__ buf, Accs ac, float* __restrict__ res, int rows, int k) {
  extern __shared__ __align__(128) unsigned char sraw[];   // the staged rows x 128 floats
  __shared__ float sh[G_THREADS];
  __shared__ float csum[G_CLUSTER_MAX];
  __shared__ __align__(8) uint64_t bar, cbar;
  const int tid = threadIdx.x;
  const int e = blockIdx.x * G_THREADS + tid;   // < 1024: 4 blocks
  const int m = rows - 8 > 1 ? rows - 8 : 1;
  constexpr bool kStatic = SK >= 0;
  const bool staged = kStatic ? SK > 0 : k > 0;
  if (SK != 0) cluster_aux_arm(&cbar);
  if (staged && tid == 0) {
    const uint32_t bytes = vmem_stage_rows(rows, k) * 512u;
    mbar_init(&bar, 1);
    fence_barrier_init();
    mbar_expect_tx(&bar, bytes);
    bulk_copy(sraw, buf, bytes, &bar);
  }
  float acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = __ldg(ac.in[q] + e);
  if (staged) {
    __syncthreads();   // the mbarrier's initialisation, before any wait
    mbar_wait(&bar, 0);
    // row e >> 7, column e & 127 of the first slice; a static build's k is SK
    vmem_patterns<SK>(smem_u32(sraw) + (uint32_t)e * 4u, m, kStatic ? SK : k, acc);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) ac.out[(size_t)q * 1024 + e] = acc[q];
  if constexpr (SK == 0) {
    if (e == 0) res[0] = res[1] = 0.f;
  } else {
    cluster_aux(chains_sum(acc), res, sh, csum, &cbar);
  }
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

// `kernel` on `blocks` blocks of G_THREADS threads launched as one cluster
// of them (at most G_CLUSTER_MAX: a portable cluster size)
template <typename... P, typename... A>
static cudaError_t launch_cluster(void (*kernel)(P...), int blocks, int smem, cudaStream_t st,
                                  A&&... args) {
  if (blocks < 1 || blocks > G_CLUSTER_MAX) return cudaErrorInvalidValue;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = blocks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(G_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gfp(const float* c, Accs ac, Reduce rd, int E, int ici, int cluster,
                              int k, cudaStream_t st) {
  if (cluster) return launch_cluster(gfp_kernel<SK>, g_blocks(E), 0, st, c, ac, E, ici, k, 1, rd);
  gfp_kernel<SK><<<g_blocks(E), G_THREADS, 0, st>>>(c, ac, E, ici, k, 0, rd);
  return cudaGetLastError();
}

template <int SK>
static cudaError_t launch_gvmem(const float* buf, Accs ac, float* res, int rows, int k,
                                cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  const int bytes = k > 0 ? vmem_stage_rows(rows, k) * 128 * 4 : 0;
  cudaError_t e = allow_smem_once(gvmem_kernel<SK>, VMEM_MAX_ROWS * 128 * 4, done);
  if (e != cudaSuccess) return e;
  return launch_cluster(gvmem_kernel<SK>, 1024 / G_THREADS, bytes, st, buf, ac, res, rows, k);
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
// accumulators, the new accumulators, then res (2 floats: [0, aux]); fp
// takes the reduction's parts and ticket counter before res (its ticket
// path's), then `ici` (0 or 1: c scaled by 1e-3, the ici modes' no-mesh
// fallback state) and `cluster` (1: its blocks, at most G_CLUSTER_MAX, as
// one cluster; 0: the ticket).
// ---------------------------------------------------------------------------
#define ACC_PARAMS const float *a0, const float *a1, const float *a2, const float *a3, float *accs_out
#define ACCS Accs{{a0, a1, a2, a3}, accs_out}
#define RED_PARAMS float *parts, unsigned *counter, float *res
#define RD Reduce{parts, counter, res}

#ifdef REPRO_STATIC_K
#if REPRO_STATIC_MODE == GMODE_FP_ADD32
extern "C" int repro_gfp_static(const float* c, ACC_PARAMS, RED_PARAMS, int E, int ici,
                                int cluster, void* stream) {
  return (int)launch_gfp<REPRO_STATIC_K>(c, ACCS, RD, E, ici, cluster, REPRO_STATIC_K,
                                         (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_MXU
extern "C" int repro_gmxu_static(const void* m0, const void* c, void* mout, float* res,
                                 void* stream) {
  return (int)launch_gmxu<REPRO_STATIC_K>(m0, c, mout, res, REPRO_STATIC_K, (cudaStream_t)stream);
}
#elif REPRO_STATIC_MODE == GMODE_VMEM
extern "C" int repro_gvmem_static(const float* buf, ACC_PARAMS, float* res, int rows,
                                  void* stream) {
  return (int)launch_gvmem<REPRO_STATIC_K>(buf, ACCS, res, rows, REPRO_STATIC_K,
                                           (cudaStream_t)stream);
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
extern "C" int repro_gfp_rt(const float* c, ACC_PARAMS, RED_PARAMS, int E, int ici, int cluster,
                            int mode, int k, void* stream) {
  return (int)launch_gfp<-1>(c, ACCS, RD, E, ici, cluster, loop_clip_k(k), (cudaStream_t)stream);
}

extern "C" int repro_gmxu_rt(const void* m0, const void* c, void* mout, float* res, int mode,
                             int k, void* stream) {
  return (int)launch_gmxu<-1>(m0, c, mout, res, loop_clip_k(k), (cudaStream_t)stream);
}

extern "C" int repro_gvmem_rt(const float* buf, ACC_PARAMS, float* res, int rows, int mode, int k,
                              void* stream) {
  return (int)launch_gvmem<-1>(buf, ACCS, res, rows, loop_clip_k(k), (cudaStream_t)stream);
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
