// Flash attention (forward) with a noise slot in every live block, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py flash_attention_pallas
// and flash_attention_pallas_rt (pallas_call at :157 and :180, body _fa_body
// :34): online-softmax attention of q (B,H,Sq,hd) over k, v (B,KH,Sk,hd) with
// GQA (kv head b*KH + h/(H/KH)), scale 1/sqrt(hd) applied to q, causal and
// sliding-window masks with whole-block skip (NEG_INF = -1e30 inside live
// blocks), out = acc / (l == 0 ? 1 : l) in q's dtype; k noise patterns per
// LIVE block at step = bh*131 + qi*17 + ki, the vmem source being the noise
// operand (the reference passes src_ref=None).
//
// What bounds it on the H100: operations. Each (query, key) pair the mask
// keeps needs two products of 2*hd operations; Qwen3-30B-A3B's attention
// (B=1, H=32, KH=4, S=4096, causal, hd=128) keeps S(S+1)/2 pairs a head,
// 1.375e11 operations, 0.278 ms at the 495 TFLOP/s TF32 dense peak (its
// 32 x 2080 live 64 x 64 blocks also compute the masked half of each
// diagonal block, 1.5% more). Its bytes (q + out 128 MiB, k + v 16 MiB)
// take 0.045 ms at 3.35 TB/s.
//
// Design for hd 64 and 128 (f32 and bf16): wgmma fed by a TMA ring.
// * One CTA per (bh, qi), 256 threads = two warpgroups, issued
//   heaviest-first (largest qi) so causal tails overlap; a loop over the
//   live kv blocks ki in place of Pallas's sequential kv grid axis.
// * A first kernel (fa_prep) writes K rounded to TF32 and V^T rounded to
//   TF32 per 64-row kv block, widening bf16 and zero-padding blocks below
//   64 rows (16 MiB of traffic at the main shape): TF32 wgmma takes K-major
//   operands only, and V (kv x hd, hd contiguous) is not K-major for P V.
// * Q is loaded once (scaled as the reference does, rounded to TF32) and
//   held in registers as wgmma A fragments for the whole kv loop. K and
//   V^T blocks stream through a ring of two stages each (128B-swizzled
//   shared memory), loaded by TMA and completed on mbarriers; the loads
//   of the next blocks are in flight during this block's products.
// * Warpgroup w computes S = Q K^T for kv columns 32w..32w+31 of the block
//   (wgmma m64n32k8, K from shared memory) and keeps it in registers: the
//   softmax runs on the accumulator fragments, the two halves exchanging
//   one row maximum per block through shared memory, which is also the
//   point where the freed stages are refilled. Then O_w += P_w V_w (wgmma
//   m64n{hd}k8, P from registers): each warpgroup holds a 64 x hd f32
//   partial output, summed across the two at the end. P's accumulator
//   layout gives each thread S columns 2t and 2t+1 of every 8; fa_prep
//   orders V^T's kv columns to match, so P feeds the product without
//   shuffles.
// * The noise slot of a live block runs after its P V products are issued,
//   overlapping them; it is emitted by the 256 threads in noise_slots.cuh's
//   ownership layout into the CTA's partial (bh*nq + qi).
// * Blocks smaller than 64 (seq 8..63): spare Q rows are zero, spare S
//   columns take no part in the max and get p = 0, spare K/V rows are zero,
//   spare output rows are not stored.
// hd 256 keeps the mma.sync kernel below (fa_kernel_mma): two K and two V
// stages would take 256 KiB, over the 227 KiB a block may hold, and Q's A
// fragments (128 registers a thread) beside the 64 x 256 output
// accumulator (128 more) exceed the 255 registers a thread may have.
#include <cuda_bf16.h>

#include <cmath>

#include "hopper.cuh"
#include "noise_slots.cuh"

#define FA_BLOCK 64       // the largest bq and bk the kernel takes
#define FA_SS 68          // S/P row stride (floats): A-fragment reads conflict-free
#define FA_NEG_INF -1e30f

// 4 consecutive elements in and 2 out, for each element type
template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float tf32f(float x) { return __uint_as_float(to_tf32(x)); }

// ===========================================================================
// wgmma design: hd 64 and 128
// ===========================================================================
#define FA_NZ_BYTES (128 * REPRO_NZ_STRIDE * 4)
#define FA_SLICE_BYTES (FA_BLOCK * HOP_ROW_BYTES)   // 64 rows x 32 floats of Q or K

template <int HD> __host__ __device__ constexpr int fa_tile_bytes() { return FA_BLOCK * HD * 4; }
template <int MODE> __host__ __device__ constexpr bool fa_staged_noise() {
  return MODE == MODE_MXU || MODE == MODE_VMEM;
}
#define FA_DEPTH 2   // K and V^T stages in the ring

// mirrored by kernels/flash_attention/kernel.py smem_bytes: FA_DEPTH K and
// V^T stages (Q passes through the first K stage on its way to registers),
// the noise operand (mxu, vmem), the row-max exchange (2 x 2 x 64 floats),
// the K and V barriers, and slack to align to 1024
template <int HD, int MODE>
__host__ __device__ constexpr int fa_wgmma_bytes() {
  return fa_tile_bytes<HD>() * 2 * FA_DEPTH + (fa_staged_noise<MODE>() ? FA_NZ_BYTES : 0) +
         1024 + 16 * FA_DEPTH + 1024;
}

// One block per (kv head, kv block): kp = K rounded to TF32, 64 rows of hd
// (rows >= bk zero); vt = V^T rounded to TF32, hd rows of 64 kv columns,
// column 8j + e holding kv row 8j + 2e (e < 4) or 8j + 2(e-4) + 1 (e >= 4),
// the order in which P's accumulator fragments hold the columns.
template <typename T, int HD>
__global__ void __launch_bounds__(REPRO_THREADS)
fa_prep(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ kp,
        float* __restrict__ vt, int Sk, int bk, int nk) {
  __shared__ float vs[FA_BLOCK][HD + 1];
  const int blk = blockIdx.x, kvh = blk / nk, ki = blk % nk;
  const size_t src = ((size_t)kvh * Sk + (size_t)ki * bk) * HD;
  float* kd = kp + (size_t)blk * FA_BLOCK * HD;
  for (int i = threadIdx.x; i < FA_BLOCK * HD / 4; i += REPRO_THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < bk) {
      x = Elem<T>::load4(k + src + (size_t)r * HD + c);
      y = Elem<T>::load4(v + src + (size_t)r * HD + c);
    }
    *reinterpret_cast<float4*>(kd + r * HD + c) =
        make_float4(tf32f(x.x), tf32f(x.y), tf32f(x.z), tf32f(x.w));
    vs[r][c] = y.x; vs[r][c + 1] = y.y; vs[r][c + 2] = y.z; vs[r][c + 3] = y.w;
  }
  __syncthreads();
  float* vd = vt + (size_t)blk * HD * FA_BLOCK;
  for (int i = threadIdx.x; i < HD * FA_BLOCK; i += REPRO_THREADS) {
    const int c = i / FA_BLOCK, pos = i % FA_BLOCK, e = pos & 7;
    vd[i] = tf32f(vs[(pos & ~7) + (e < 4 ? 2 * e : 2 * e - 7)][c]);
  }
}

template <typename T, int HD, int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS, 1)
fa_kernel_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const T* __restrict__ q, const float* __restrict__ noise, T* __restrict__ out,
                float* __restrict__ partials, int H, int KH, int Sq, int Sk, int bq, int bk,
                int causal, int window, float scale, int kn) {
  constexpr int D = FA_DEPTH;
  static_assert(fa_wgmma_bytes<HD, MODE>() <= REPRO_SMEM_MAX, "shared memory");
  constexpr int TILE = fa_tile_bytes<HD>();
  constexpr int NJ = HD / 8;   // 8-column output chunks: o holds 4 floats of each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);              // D stages of K: HD/32 swizzled 64 x 32 slices
  uint8_t* Qs = Ks;                                // Q, like K, until it is in registers
  uint8_t* Vs = Ks + D * TILE;                     // D stages of V^T: two hd x 32 halves
  float* Ns = reinterpret_cast<float*>(Vs + D * TILE);   // mxu / vmem: noise operand
  float* red = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(Ns) +
                                        (fa_staged_noise<MODE>() ? FA_NZ_BYTES : 0));
  uint64_t* kfull = reinterpret_cast<uint64_t*>(red + 256);
  uint64_t* vfull = kfull + D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nq = Sq / bq, nk = Sk / bk;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // heaviest causal blocks first
  const int kvh = (bh / H) * KH + (bh % H) / (H / KH);
  const int q0 = qi * bq;
  // live kv blocks lo..hi: not entirely above the diagonal, not entirely
  // out of the window
  int hi = nk - 1, lo = 0;
  if (causal) hi = min(hi, (q0 + bq - 1) / bk);
  if (window)
    while (lo <= hi && q0 - (lo * bk + bk - 1) >= window) ++lo;
  const int n_live = hi - lo + 1;

  if (tid == 0) {
    for (int s = 0; s < D; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
    }
    fence_barrier_init();
  }
  for (int i = tid; i < FA_BLOCK * HD / 4; i += REPRO_THREADS) {   // Q * scale, TF32
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < bq) {
      x = Elem<T>::load4(q + ((size_t)bh * Sq + q0 + r) * HD + c);
      x = make_float4(tf32f(x.x * scale), tf32f(x.y * scale), tf32f(x.z * scale),
                      tf32f(x.w * scale));
    }
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(Qs + (c >> 5) * FA_SLICE_BYTES) +
                               swz(r, c & 31)) = x;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fc[4];
  if constexpr (MODE == MODE_FP) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fc[r] = __ldg(noise + own_row(tid, r) * 128 + own_col(tid));
  }
  if constexpr (fa_staged_noise<MODE>()) stage_noise(noise, Ns, tid);
  __syncthreads();

  // Q as wgmma A fragments, held for the whole kv loop: k-step kc of warp
  // w's rows r0 = 16w + g and r1 = r0 + 8 at columns 8kc + t and 8kc + t + 4
  const int r0 = (warp & 3) * 16 + g, r1 = r0 + 8;   // this thread's two rows
  uint32_t qa[HD / 8][4];
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    const uint32_t* qs = reinterpret_cast<const uint32_t*>(Qs + (kc >> 2) * FA_SLICE_BYTES);
    const int col = (kc & 3) * 8 + t;
    qa[kc][0] = qs[swz(r0, col)];
    qa[kc][1] = qs[swz(r1, col)];
    qa[kc][2] = qs[swz(r0, col + 4)];
    qa[kc][3] = qs[swz(r1, col + 4)];
  }
  fence_proxy_async();   // Q's slot in the first K stage goes back to TMA
  __syncthreads();

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_k = [=](int i) {   // live block i into K stage i % D
    const int s = i % D, row = (kvh * nk + lo + i) * FA_BLOCK;
    mbar_expect_tx(&kfull[s], TILE);
    for (int c = 0; c < HD / 32; ++c)
      tma_load_2d(Ks + s * TILE + c * FA_SLICE_BYTES, mk, &kfull[s], c * 32, row);
  };
  auto load_v = [=](int i) {   // and its V^T into V stage i % D
    const int s = i % D, row = (kvh * nk + lo + i) * HD;
    mbar_expect_tx(&vfull[s], TILE);
    for (int h = 0; h < 2; ++h)
      tma_load_2d(Vs + s * TILE + h * HD * HOP_ROW_BYTES, mv, &vfull[s], h * 32, row);
  };
  if (tid == 0) {
    for (int i = 0; i < D && i < n_live; ++i) load_k(i);
    for (int i = 0; i < D - 1 && i < n_live; ++i) load_v(i);
  }

  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  const int qp0 = q0 + r0, qp1 = q0 + r1;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int ki = lo + i, k0 = ki * bk, s = i % D;
    const uint32_t par = (i / D) & 1;

    // S = (q * scale) K^T for this warpgroup's 32 kv columns
    float sc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = 0.f;
    mbar_wait(&kfull[s], par);
    wgmma_fence();
    const uint8_t* ks = Ks + s * TILE + wg * 32 * HOP_ROW_BYTES;
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc)
      wgmma_m64n32k8_rs(sc, qa[kc], desc_sw128(ks + (kc >> 2) * FA_SLICE_BYTES) + (kc & 3) * 2, 1);
    wgmma_commit();
    wgmma_wait<0>();   // also the previous block's P V
    fence_regs(sc);
    fence_regs(o);

    // mask; this half's row maxima, exchanged with the other warpgroup
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wg * 32 + j * 8 + 2 * t + e, kpos = k0 + col;
        const bool keep0 = (!causal || qp0 >= kpos) && (!window || qp0 - kpos < window);
        const bool keep1 = (!causal || qp1 >= kpos) && (!window || qp1 - kpos < window);
        sc[4 * j + e] = keep0 ? sc[4 * j + e] : FA_NEG_INF;
        sc[4 * j + 2 + e] = keep1 ? sc[4 * j + 2 + e] : FA_NEG_INF;
        if (col < bk) {
          mx0 = fmaxf(mx0, sc[4 * j + e]);
          mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
        }
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float* rb = red + (i & 1) * 128;
    if (t == 0) {
      rb[wg * 64 + r0] = mx0;
      rb[wg * 64 + r1] = mx1;
    }
    __syncthreads();   // both halves' S are done: K stage s and V of block i-1 are free
    if (tid == 0) {
      if (i + D < n_live) load_k(i + D);
      if (i + D - 1 < n_live) load_v(i + D - 1);
    }
    const float mn0 = fmaxf(m0, fmaxf(rb[r0], rb[64 + r0]));
    const float mn1 = fmaxf(m1, fmaxf(rb[r1], rb[64 + r1]));

    // P = exp(S - m), row sums, corrections
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = wg * 32 + j * 8 + 2 * t + e < bk;
        const float p0 = valid ? expf(sc[4 * j + e] - mn0) : 0.f;
        const float p1 = valid ? expf(sc[4 * j + 2 + e] - mn1) : 0.f;
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    const float cr0 = expf(m0 - mn0), cr1 = expf(m1 - mn1);
    l0 = cr0 * l0 + sum0;
    l1 = cr1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[4 * j] *= cr0; o[4 * j + 1] *= cr0;
      o[4 * j + 2] *= cr1; o[4 * j + 3] *= cr1;
    }

    // O_w += P_w V_w: P's fragment columns t and t+4 are S columns 2t, 2t+1
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = to_tf32(sc[4 * j]);
      pa[j][1] = to_tf32(sc[4 * j + 2]);
      pa[j][2] = to_tf32(sc[4 * j + 1]);
      pa[j][3] = to_tf32(sc[4 * j + 3]);
    }
    mbar_wait(&vfull[s], par);
    wgmma_fence();
    const uint64_t dv = desc_sw128(Vs + s * TILE + wg * HD * HOP_ROW_BYTES);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (HD == 128) wgmma_m64n128k8_rs(o, pa[j], dv + 2 * j, 1);
      else wgmma_m64n64k8_rs(o, pa[j], dv + 2 * j, 1);
    }
    wgmma_commit();

    // noise slot of this live block, overlapping the P V products
    const int step = bh * 131 + qi * 17 + ki;
    if constexpr (MODE == MODE_FP) fp_noise<SK>(acc, fc, kn);
    else if constexpr (MODE == MODE_VMEM) vmem_noise<SK>(acc, Ns, REPRO_NZ_STRIDE, 128, 128, step, kn, tid);
    else if constexpr (MODE == MODE_MXU) mxu_noise_lean<SK>(acc, Ns, REPRO_NZ_STRIDE, kn, tid);
  }
  wgmma_wait<0>();
  fence_regs(o);

  // out = (O_0 + O_1) / (l_0 + l_1): warpgroup w finishes columns of half w
  __syncthreads();   // no product reads the stages any more
  constexpr int XS = HD + 8;
  float* xo = reinterpret_cast<float*>(Ks);   // 64 x XS: the other half's partial
  if (t == 0) {
    red[wg * 64 + r0] = l0;
    red[wg * 64 + r1] = l1;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j / (NJ / 2) != wg) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<float2*>(xo + r0 * XS + col) = make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(xo + r1 * XS + col) = make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  __syncthreads();
  const float lt0 = red[r0] + red[64 + r0], lt1 = red[r1] + red[64 + r1];
  const float sf0 = lt0 == 0.f ? 1.f : lt0, sf1 = lt1 == 0.f ? 1.f : lt1;
  T* orow = out + ((size_t)bh * Sq + q0) * HD;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j / (NJ / 2) == wg) {
      const int col = j * 8 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(xo + r0 * XS + col);
      const float2 x1 = *reinterpret_cast<const float2*>(xo + r1 * XS + col);
      if (r0 < bq)
        Elem<T>::store2(orow + (size_t)r0 * HD + col, (o[4 * j] + x0.x) / sf0,
                        (o[4 * j + 1] + x0.y) / sf0);
      if (r1 < bq)
        Elem<T>::store2(orow + (size_t)r1 * HD + col, (o[4 * j + 2] + x1.x) / sf1,
                        (o[4 * j + 3] + x1.y) / sf1);
    }
  write_partial<MODE>(partials + ((size_t)bh * nq + qi) * REPRO_NACC, acc, tid);
}

// kp, vt: f32 scratch of B*KH*(Sk/bk)*64*hd floats each
template <typename T, int HD, int MODE, int SK>
static cudaError_t launch_fa_wgmma(const void* q, const void* k, const void* v,
                                   const float* noise, void* out, float* kp, float* vt,
                                   float* partials, float* scratch, float* nacc, int B, int H,
                                   int KH, int Sq, int Sk, int bq, int bk, int causal, int window,
                                   int smem, int kn, cudaStream_t st) {
  if (smem != fa_wgmma_bytes<HD, MODE>()) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fa_kernel_wgmma<T, HD, MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  const int nk = Sk / bk, blocks = B * KH * nk;
  CUtensorMap tk, tv;
  if ((e = make_map_f32(&tk, kp, HD, blocks * FA_BLOCK, FA_BLOCK)) != cudaSuccess) return e;
  if ((e = make_map_f32(&tv, vt, FA_BLOCK, blocks * HD, HD)) != cudaSuccess) return e;
  fa_prep<T, HD><<<blocks, REPRO_THREADS, 0, st>>>((const T*)k, (const T*)v, kp, vt, Sk, bk, nk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the reference's scale: 1.0 / math.sqrt(hd) in double, used as an f32
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  const int n_cta = B * H * (Sq / bq);
  fa_kernel_wgmma<T, HD, MODE, SK><<<n_cta, REPRO_THREADS, smem, st>>>(
      tk, tv, (const T*)q, noise, (T*)out, partials, H, KH, Sq, Sk, bq, bk, causal, window, scale,
      kn);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_partials(partials, n_cta, scratch, nacc, st);
}

// ===========================================================================
// mma.sync design, kept for hd 256
// ===========================================================================
// * 256 threads = 8 warps; running max and sum in shared memory, one float
//   per row; the output accumulator in mma C fragments (warp w owns rows
//   16*(w%4).. and half of the hd columns). S = Q K^T and O += P V run as
//   mma.sync m16n8k8 TF32 from shared memory; softmax in IEEE f32 (expf),
//   four threads per row through an S/P tile in shared memory.
// * Shared memory: Q (scaled, f32) 64 x (hd+4), one K/V buffer 64 x (hd+8)
//   that holds K for S and then V for P V, S/P 64 x 68, and for mxu/vmem
//   the 128 x 132 noise operand: 215 KiB at hd=256. bf16 q/k/v are
//   widened to f32 when they are staged.

template <int HD> __host__ __device__ constexpr int fa_qs() { return HD + 4; }   // Q row stride
template <int HD> __host__ __device__ constexpr int fa_kvs() { return HD + 8; }  // K/V row stride

template <int HD, int MODE>
__host__ __device__ constexpr int fa_mma_bytes() {
  return (FA_BLOCK * fa_qs<HD>() + FA_BLOCK * fa_kvs<HD>() + FA_BLOCK * FA_SS + 3 * FA_BLOCK +
          ((MODE == MODE_MXU || MODE == MODE_VMEM) ? 128 * REPRO_NZ_STRIDE : 0)) *
         (int)sizeof(float);
}

// Copy `rows` rows of HD elements (row-major, contiguous) into a 64-row f32
// tile with row stride `stride`, multiplied by `mul`; rows >= `rows` are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int rows, float* dst,
                                           int stride, float mul, int tid) {
  constexpr int C4 = HD / 4;
  for (int i = tid; i < FA_BLOCK * C4; i += REPRO_THREADS) {
    const int r = i / C4, c4 = i % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      x = Elem<T>::load4(src + (size_t)r * HD + c4 * 4);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c4 * 4) = x;
  }
}

template <typename T, int HD, int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS)
fa_kernel_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ noise, T* __restrict__ out, float* __restrict__ partials,
          int H, int KH, int Sq, int Sk, int bq, int bk, int causal, int window, float scale,
          int kn) {
  constexpr int QS = fa_qs<HD>(), KVS = fa_kvs<HD>();
  constexpr int NT = HD / 16;  // 8-column output tiles per warp (half of hd)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // 64 x QS, q * scale
  float* KVs = Qs + FA_BLOCK * QS;        // 64 x KVS: K, then V
  float* Ss = KVs + FA_BLOCK * KVS;       // 64 x FA_SS: S, then P
  float* m_s = Ss + FA_BLOCK * FA_SS;     // running max per row
  float* l_s = m_s + FA_BLOCK;            // running sum per row
  float* c_s = l_s + FA_BLOCK;            // this block's correction per row
  float* Ns = c_s + FA_BLOCK;             // mxu / vmem: 128 x REPRO_NZ_STRIDE

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;  // warp tile: rows 16*mt.., column half nh
  const int nq = Sq / bq, nk = Sk / bk;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // heaviest causal blocks first
  const int kvh = (bh / H) * KH + (bh % H) / (H / KH);
  const int q0 = qi * bq;

  stage_tile<T, HD>(q + ((size_t)bh * Sq + q0) * HD, bq, Qs, QS, scale, tid);
  if (tid < FA_BLOCK) {
    m_s[tid] = FA_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fc[4];
  if constexpr (MODE == MODE_FP) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fc[r] = __ldg(noise + own_row(tid, r) * 128 + own_col(tid));
  }
  if constexpr (MODE == MODE_MXU || MODE == MODE_VMEM) stage_noise(noise, Ns, tid);

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * bk;
    if (causal && k0 > q0 + bq - 1) continue;             // entirely above the diagonal
    if (window && q0 - (k0 + bk - 1) >= window) continue;  // entirely out of the window

    __syncthreads();  // the previous block's P V is done with KVs and Ss
    stage_tile<T, HD>(k + ((size_t)kvh * Sk + k0) * HD, bk, KVs, KVS, 1.f, tid);
    __syncthreads();

    // S = (q * scale) K^T: warp tile 16 x 32
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < HD; kc += 8) {
      const float* ar = Qs + (mt * 16 + g) * QS + kc + t;
      const uint32_t a0 = to_tf32(ar[0]), a1 = to_tf32(ar[8 * QS]);
      const uint32_t a2 = to_tf32(ar[4]), a3 = to_tf32(ar[8 * QS + 4]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* br = KVs + (nh * 32 + nt * 8 + g) * KVS + kc + t;
        mma_tf32(s[nt], a0, a1, a2, a3, to_tf32(br[0]), to_tf32(br[4]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* sr = Ss + (mt * 16 + g) * FA_SS + nh * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(sr) = make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(sr + 8 * FA_SS) = make_float2(s[nt][2], s[nt][3]);
    }
    __syncthreads();

    // online softmax: four threads per row, 16 columns each
    {
      const int r = tid >> 2, c0 = (tid & 3) * 16;
      const int qpos = q0 + r;
      float* sr = Ss + r * FA_SS + c0;
      float x[16];
      float mloc = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int kpos = k0 + c0 + c;
        x[c] = sr[c];
        if (c0 + c < bk) {
          const bool keep = (!causal || qpos >= kpos) && (!window || qpos - kpos < window);
          x[c] = keep ? x[c] : FA_NEG_INF;
          mloc = fmaxf(mloc, x[c]);
        }
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mloc);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = (c0 + c < bk) ? expf(x[c] - m_new) : 0.f;
        sr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) {   // every lane of the row read m_prev before the shuffles
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // P and the corrections are in; K is no longer read
    stage_tile<T, HD>(v + ((size_t)kvh * Sk + k0) * HD, bk, KVs, KVS, 1.f, tid);
    __syncthreads();

    // O = O * corr + P V: warp tile 16 x hd/2
    {
      const float cl = c_s[mt * 16 + g], ch = c_s[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= cl; o[nt][1] *= cl;
        o[nt][2] *= ch; o[nt][3] *= ch;
      }
      for (int kc = 0; kc < bk; kc += 8) {
        const float* ar = Ss + (mt * 16 + g) * FA_SS + kc + t;
        const uint32_t a0 = to_tf32(ar[0]), a1 = to_tf32(ar[8 * FA_SS]);
        const uint32_t a2 = to_tf32(ar[4]), a3 = to_tf32(ar[8 * FA_SS + 4]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* br = KVs + (kc + t) * KVS + nh * (HD / 2) + nt * 8 + g;
          mma_tf32(o[nt], a0, a1, a2, a3, to_tf32(br[0]), to_tf32(br[4 * KVS]));
        }
      }
    }

    // noise slot of this live block
    const int step = bh * 131 + qi * 17 + ki;
    if constexpr (MODE == MODE_FP) fp_noise<SK>(acc, fc, kn);
    else if constexpr (MODE == MODE_VMEM) vmem_noise<SK>(acc, Ns, REPRO_NZ_STRIDE, 128, 128, step, kn, tid);
    else if constexpr (MODE == MODE_MXU) mxu_noise<SK>(acc, Ns, REPRO_NZ_STRIDE, kn, tid);
  }
  __syncthreads();  // l_s is final (also when no block was live)

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = mt * 16 + g + 8 * half;
    if (row < bq) {
      const float l = l_s[row];
      const float safe = l == 0.f ? 1.f : l;
      T* orow = out + ((size_t)bh * Sq + q0 + row) * HD + nh * (HD / 2) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        Elem<T>::store2(orow + nt * 8, o[nt][2 * half] / safe, o[nt][2 * half + 1] / safe);
    }
  }
  write_partial<MODE>(partials + ((size_t)bh * nq + qi) * REPRO_NACC, acc, tid);
}

template <typename T, int HD, int MODE, int SK>
static cudaError_t launch_fa_mma(const void* q, const void* k, const void* v,
                                 const float* noise, void* out, float* partials, float* scratch,
                                 float* nacc, int B, int H, int KH, int Sq, int Sk, int bq, int bk,
                                 int causal, int window, int smem, int kn, cudaStream_t st) {
  if (smem != fa_mma_bytes<HD, MODE>()) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fa_kernel_mma<T, HD, MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  // the reference's scale: 1.0 / math.sqrt(hd) in double, used as an f32
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  const int n_cta = B * H * (Sq / bq);
  fa_kernel_mma<T, HD, MODE, SK><<<n_cta, REPRO_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, noise, (T*)out, partials, H, KH, Sq, Sk, bq, bk,
      causal, window, scale, kn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_partials(partials, n_cta, scratch, nacc, st);
}

// dtype: 0 = float32, 1 = bfloat16; hd 64 and 128 take the wgmma kernel,
// hd 256 the mma.sync one
template <int MODE, int SK>
static cudaError_t dispatch_fa(const void* q, const void* k, const void* v, const float* noise,
                               void* out, float* kp, float* vt, float* partials, float* scratch,
                               float* nacc, int B, int H, int KH, int Sq, int Sk, int hd, int bq,
                               int bk, int causal, int window, int dtype, int smem, int kn,
                               cudaStream_t st) {
#define FA_CASE(TYPE, HDV)                                                                       \
  if constexpr (HDV == 256)                                                                      \
    return launch_fa_mma<TYPE, HDV, MODE, SK>(q, k, v, noise, out, partials, scratch, nacc, B, H, \
                                              KH, Sq, Sk, bq, bk, causal, window, smem, kn, st); \
  else                                                                                           \
    return launch_fa_wgmma<TYPE, HDV, MODE, SK>(q, k, v, noise, out, kp, vt, partials, scratch,   \
                                                nacc, B, H, KH, Sq, Sk, bq, bk, causal, window,  \
                                                smem, kn, st)
#ifdef REPRO_STATIC_HD   // a static-k build holds the one variant it was built for
  if (hd != REPRO_STATIC_HD || dtype != REPRO_STATIC_BF16) return cudaErrorInvalidValue;
#if REPRO_STATIC_BF16
  FA_CASE(__nv_bfloat16, REPRO_STATIC_HD);
#else
  FA_CASE(float, REPRO_STATIC_HD);
#endif
#else
  if (dtype == 0) {
    if (hd == 64) { FA_CASE(float, 64); }
    if (hd == 128) { FA_CASE(float, 128); }
    if (hd == 256) { FA_CASE(float, 256); }
  } else if (dtype == 1) {
    if (hd == 64) { FA_CASE(__nv_bfloat16, 64); }
    if (hd == 128) { FA_CASE(__nv_bfloat16, 128); }
    if (hd == 256) { FA_CASE(__nv_bfloat16, 256); }
  }
  return cudaErrorInvalidValue;
#endif
#undef FA_CASE
}

// kp, vt: scratch for the wgmma kernel's K and V^T (unused at hd 256);
// smem: the wrapper's mirror of the kernel's shared memory (refused if it
// disagrees)
#ifdef REPRO_STATIC_K
extern "C" int repro_attention_static(const void* q, const void* k, const void* v,
                                      const float* noise, void* out, float* kp, float* vt,
                                      float* partials, float* scratch, float* nacc, int B, int H,
                                      int KH, int Sq, int Sk, int hd, int bq, int bk, int causal,
                                      int window, int dtype, int smem, void* stream) {
  return (int)dispatch_fa<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      q, k, v, noise, out, kp, vt, partials, scratch, nacc, B, H, KH, Sq, Sk, hd, bq, bk, causal,
      window, dtype, smem, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_attention_rt(const void* q, const void* k, const void* v, const float* noise,
                                  void* out, float* kp, float* vt, float* partials,
                                  float* scratch, float* nacc, int B, int H, int KH, int Sq,
                                  int Sk, int hd, int bq, int bk, int causal, int window,
                                  int dtype, int smem, int mode, int kn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  kn = clip_k(kn);
#define FA_MODE(M)                                                                             \
  return (int)dispatch_fa<M, -1>(q, k, v, noise, out, kp, vt, partials, scratch, nacc, B, H, KH, \
                                 Sq, Sk, hd, bq, bk, causal, window, dtype, smem, kn, st)
  switch (mode) {
    case MODE_NONE: FA_MODE(MODE_NONE);
    case MODE_FP: FA_MODE(MODE_FP);
    case MODE_MXU: FA_MODE(MODE_MXU);
    case MODE_VMEM: FA_MODE(MODE_VMEM);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_MODE
}
#endif
