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
// take 0.045 ms at 3.35 TB/s. gemma-2b's (B=1, H=8, KH=1, S=4096, causal,
// hd=256): 6.87e10 operations, 0.139 ms; 72 MiB, 0.022 ms.
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
// hd 256 takes fa_kernel_h256 below, the same design with hd split between
// the warpgroups: two 64-row K and two V^T stages would take 256 KiB, over
// the 227 KiB a block may hold, and Q's A fragments over all of hd (128
// registers a thread) beside a 64 x 256 output accumulator (128 more)
// exceed the 255 registers a thread may have.
#include <cuda_bf16.h>

#include <cmath>

#include "hopper.cuh"
#include "noise_slots.cuh"

#define FA_BLOCK 64       // the largest bq and bk the kernel takes
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
// the order in which P's accumulator fragments hold the columns. At hd 256
// two blocks share a (kv head, kv block), 128 columns each (blockIdx.y), so
// V's tile stays within the 48 KiB of static shared memory; a launch of few
// kv blocks (a short sequence) splits their rows in two too (gridDim.z), so
// they spread over more SMs.
template <typename T, int HD>
__global__ void __launch_bounds__(REPRO_THREADS)
fa_prep(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ kp,
        float* __restrict__ vt, int Sk, int bk, int nk) {
  constexpr int CW = HD > 128 ? 128 : HD;              // columns a block takes
  const int RW = HD > 128 ? FA_BLOCK / gridDim.z : FA_BLOCK;   // rows a block takes
  __shared__ float vs[FA_BLOCK][CW + 1];
  const int blk = blockIdx.x, kvh = blk / nk, ki = blk % nk;
  const int c0 = HD > 128 ? blockIdx.y * CW : 0, r0 = HD > 128 ? blockIdx.z * RW : 0;
  const size_t src = ((size_t)kvh * Sk + (size_t)ki * bk) * HD + c0;
  float* kd = kp + (size_t)blk * FA_BLOCK * HD + c0;
  float* vd = vt + (size_t)blk * HD * FA_BLOCK + (size_t)c0 * FA_BLOCK + r0;
  for (int i = threadIdx.x; i < RW * CW / 4; i += REPRO_THREADS) {
    const int r = r0 + i / (CW / 4), c = (i % (CW / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < bk) {
      x = Elem<T>::load4(k + src + (size_t)r * HD + c);
      y = Elem<T>::load4(v + src + (size_t)r * HD + c);
    }
    *reinterpret_cast<float4*>(kd + r * HD + c) =
        make_float4(tf32f(x.x), tf32f(x.y), tf32f(x.z), tf32f(x.w));
    float* vr = vs[r - r0];
    vr[c] = y.x; vr[c + 1] = y.y; vr[c + 2] = y.z; vr[c + 3] = y.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < CW * RW; i += REPRO_THREADS) {
    const int c = i / RW, pos = i % RW, e = pos & 7;
    vd[c * FA_BLOCK + pos] = tf32f(vs[(pos & ~7) + (e < 4 ? 2 * e : 2 * e - 7)][c]);
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
// wgmma design: hd 256
// ===========================================================================
// * One CTA per (bh, qi) as above; the two warpgroups split hd. Warpgroup w
//   holds Q[:, 128w .. 128w+127] as A fragments (64 registers a thread) and
//   computes its half of every S = Q K^T (wgmma m64n32k8, a partial sum over
//   its 128 hd columns); the halves are summed through a 16 KiB exchange in
//   shared memory, so both warpgroups hold the same S, the same row maxima
//   and sums, and compute O[:, 128w .. 128w+127] += P V[:, the same
//   columns] (wgmma m64n128k8, P from registers): 64 accumulator registers,
//   no partial output to sum at the end.
// * The kv loop walks sub-blocks of 32 rows of each live 64-row block
//   (FA_H_SUB): K and V^T stages of 32 KiB in a ring of FA_DEPTH each (64 KiB
//   stages would leave room for one of each beside the noise operand).
//   Sub-block j + 2's K and j + 1's V^T are loaded by TMA while sub-block j
//   runs, each warpgroup's first warp loading the half its warpgroup reads,
//   after issuing P V's products. Two block barriers a sub-block: after S
//   (both halves done with the K stage, the previous P V with its V^T
//   stage, the exchange read), and after the exchange is written.
// * Sub-block j + 1's S products (a second 16-register S) are issued once
//   j's row maxima are known and O is rescaled, before j's exponentials;
//   then j's P V products. Issuing products with A in registers holds the
//   warps for about the products' own time, so little of the softmax runs
//   beside them. No product is in flight while O is rescaled (see
//   fa_h256_s).
// * The online softmax runs per sub-block (the reference's per-block maximum
//   and sum, taken in two steps: equal up to rounding), on the accumulator
//   fragments; the noise slot of a live block runs once, after the P V
//   products of its last sub-block are issued.
// * CTAs start heaviest first over the whole grid (every head's last q
//   block, then the one before, ...), so the lightest start last; at
//   gemma-2b's 8 heads x 64 q blocks, head by head left a tail of about a
//   fifth of the run.
// * Shared memory: 2 x 32 KiB of K (Q passes through them on its way to
//   registers), 2 x 32 KiB of V^T, the exchange, the noise operand in mxu and
//   vmem (211 KiB in all).
#define FA_H_SUB 32                                  // kv rows of a sub-block
#define FA_H_STAGE (FA_H_SUB * 256 * 4)              // one K or V^T stage: 32 KiB
#define FA_H_SLICE (FA_H_SUB * HOP_ROW_BYTES)        // 32 kv rows x 32 floats of K
#define FA_H_XCH (2 * 128 * 16 * 4)                  // each thread's 16 floats of S, twice
// A static build's mxu and vmem slots unroll at most 12 patterns (the
// static audit's K_HI): beside the 64 + 64 + 32 registers the loop keeps,
// 64 unrolled vmem patterns spilled. Past 12 they loop over the static k,
// passed at run time, and add as the unrolled patterns do.
#define FA_H_SLOT_SK(SK) ((SK) > 12 ? -1 : (SK))

// mirrored by kernels/flash_attention/kernel.py smem_bytes: FA_DEPTH K and
// V^T stages, the noise operand (mxu, vmem), the exchange, the K and V
// barriers, and slack to align to 1024
template <int MODE>
__host__ __device__ constexpr int fa_h256_bytes() {
  return FA_H_STAGE * 2 * FA_DEPTH + (fa_staged_noise<MODE>() ? FA_NZ_BYTES : 0) + FA_H_XCH +
         16 * FA_DEPTH + 1024;
}

// s = this warpgroup's half of S over K stage ks (its half of hd), once the
// stage's barrier `full` completes phase `par`; committed, not waited. The
// first product ignores s's old value (scale-d 0) in place of zeroing it:
// an instruction that writes an accumulator while a product group is in
// flight makes ptxas serialize every wgmma of the kernel (C7515).
__device__ __forceinline__ void fa_h256_s(float (&s)[16], const uint32_t (&qa)[16][4],
                                          const uint8_t* ks, uint64_t* full, uint32_t par) {
  mbar_wait(full, par);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 16; ++kc)
    wgmma_m64n32k8_rs(s, qa[kc], desc_sw128(ks + (kc >> 2) * FA_H_SLICE) + (kc & 3) * 2, kc > 0);
  wgmma_commit();
}

template <typename T, int MODE, int SK>
__global__ void __launch_bounds__(REPRO_THREADS, 1)
fa_kernel_h256(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const T* __restrict__ q, const float* __restrict__ noise, T* __restrict__ out,
               float* __restrict__ partials, int H, int KH, int Sq, int Sk, int bq, int bk,
               int causal, int window, float scale, int kn) {
  constexpr int HD = 256, D = FA_DEPTH;
  static_assert(fa_h256_bytes<MODE>() <= REPRO_SMEM_MAX, "shared memory");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);              // D stages of K: 8 swizzled 32 x 32 slices
  uint8_t* Qs = Ks;                                // Q, 8 swizzled 64 x 32 slices, until it is in registers
  uint8_t* Vs = Ks + D * FA_H_STAGE;               // D stages of V^T: 256 rows of 32 kv columns
  float* Ns = reinterpret_cast<float*>(Vs + D * FA_H_STAGE);   // mxu / vmem: noise operand
  float4* xch = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(Ns) +
                                          (fa_staged_noise<MODE>() ? FA_NZ_BYTES : 0));
  uint64_t* kfull = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(xch) + FA_H_XCH);
  uint64_t* vfull = kfull + D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wt = tid & 127, g = lane >> 2, t = lane & 3;
  const int nq = Sq / bq, nk = Sk / bk, n_bh = gridDim.x / nq;
  // heaviest causal blocks first over the whole grid (every head's qi =
  // nq - 1, then nq - 2, ...): the last CTAs to start are the lightest
  const int bh = blockIdx.x % n_bh;
  const int qi = nq - 1 - blockIdx.x / n_bh;
  const int kvh = (bh / H) * KH + (bh % H) / (H / KH);
  const int q0 = qi * bq;
  int hi = nk - 1, lo = 0;
  if (causal) hi = min(hi, (q0 + bq - 1) / bk);
  if (window)
    while (lo <= hi && q0 - (lo * bk + bk - 1) >= window) ++lo;
  const int nsub = bk > FA_H_SUB ? 2 : 1;   // a block of 32 rows or fewer is one sub-block
  const int n_sub = (hi - lo + 1) * nsub;

  if (tid == 0) {
    for (int s = 0; s < D; ++s) {   // each warpgroup loads its half of a stage
      mbar_init(&kfull[s], 2);
      mbar_init(&vfull[s], 2);
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

  // this warpgroup's half of Q as A fragments: k-step kc is hd columns
  // 128w + 8kc + t and + 4 of rows r0 = 16(warp % 4) + g and r1 = r0 + 8
  const int r0 = (warp & 3) * 16 + g, r1 = r0 + 8;
  uint32_t qa[16][4];
#pragma unroll
  for (int kc = 0; kc < 16; ++kc) {
    const uint32_t* qs =
        reinterpret_cast<const uint32_t*>(Qs + (4 * wg + (kc >> 2)) * FA_SLICE_BYTES);
    const int col = (kc & 3) * 8 + t;
    qa[kc][0] = qs[swz(r0, col)];
    qa[kc][1] = qs[swz(r1, col)];
    qa[kc][2] = qs[swz(r0, col + 4)];
    qa[kc][3] = qs[swz(r1, col + 4)];
  }
  fence_proxy_async();   // Q's slots in the K stages go back to TMA
  __syncthreads();

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  // The first warp of each warpgroup loads the half of a stage its
  // warpgroup reads (K's hd slices 4w..4w+3, V^T's rows 128w..), its lanes
  // issuing the copies at once: an issuing thread stalls until the SM's
  // copy queue takes them (~600 clocks a sub-block for all nine from one
  // thread), so they are issued where the warp would wait anyway.
  const bool loader = (warp & 3) == 0;
  auto load_k = [=](int j) {   // sub-block j into K stage j % D: lane c, slice 4w + c
    const int s = j % D, c = 4 * wg + lane;
    const int row = (kvh * nk + lo + j / nsub) * FA_BLOCK + (j % nsub) * FA_H_SUB;
    if (lane == 0) mbar_expect_tx(&kfull[s], FA_H_STAGE / 2);
    if (lane < 4) tma_load_2d(Ks + s * FA_H_STAGE + c * FA_H_SLICE, mk, &kfull[s], c * 32, row);
  };
  auto load_v = [=](int j) {   // and its V^T into V stage j % D: lane 4
    const int s = j % D;
    if (lane == 4) {
      mbar_expect_tx(&vfull[s], FA_H_STAGE / 2);
      tma_load_2d(Vs + s * FA_H_STAGE + wg * 128 * HOP_ROW_BYTES, mv, &vfull[s],
                  (j % nsub) * FA_H_SUB, (kvh * nk + lo + j / nsub) * HD + 128 * wg);
    }
  };
  if (loader) {
    for (int j = 0; j < D && j < n_sub; ++j) load_k(j);
    for (int j = 0; j < D - 1 && j < n_sub; ++j) load_v(j);
  }

  float o[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) o[j] = 0.f;
  fence_regs(o);   // zeroed ahead of the first S products
  const int qp0 = q0 + r0, qp1 = q0 + r1;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;
  float4* xmine = xch + wg * 4 * 128 + wt;        // [warpgroup][4][128] float4
  const float4* xother = xch + (1 - wg) * 4 * 128 + wt;
  const uint8_t* kwg = Ks + 4 * wg * FA_H_SLICE;  // this warpgroup's half of a K stage

  // this warpgroup's half of S = (q * scale) K^T over the 32 kv rows of a
  // sub-block: sn holds the next sub-block's while this one's softmax runs
  float sn[16];
  if (n_sub > 0) fa_h256_s(sn, qa, kwg, &kfull[0], 0);
  for (int j = 0; j < n_sub; ++j) {
    const int ki = lo + j / nsub, h = j % nsub, s = j % D;
    wgmma_wait<0>();   // this sub-block's S and the previous one's P V
    fence_regs(sn);
    fence_regs(o);
    float sc[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) sc[x] = sn[x];
    __syncthreads();   // K stage s, V stage (j+1) % D and the exchange are free

    // S = S_0 + S_1: the same sum, bitwise, in both warpgroups
#pragma unroll
    for (int x = 0; x < 4; ++x)
      xmine[x * 128] = make_float4(sc[4 * x], sc[4 * x + 1], sc[4 * x + 2], sc[4 * x + 3]);
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 y = xother[x * 128];
      sc[4 * x] += y.x;
      sc[4 * x + 1] += y.y;
      sc[4 * x + 2] += y.z;
      sc[4 * x + 3] += y.w;
    }

    // mask (only a sub-block on the diagonal, at the window's edge or with
    // spare columns has one: the same for every thread); row maxima over
    // the sub-block's columns
    const int kb = ki * bk + h * FA_H_SUB;
    const bool edge = h * FA_H_SUB + FA_H_SUB > bk || (causal && kb + FA_H_SUB - 1 > q0) ||
                      (window && q0 + bq - 1 - kb >= window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = h * FA_H_SUB + x * 8 + 2 * t + e, kpos = ki * bk + col;
        if (edge) {
          const bool keep0 = (!causal || qp0 >= kpos) && (!window || qp0 - kpos < window);
          const bool keep1 = (!causal || qp1 >= kpos) && (!window || qp1 - kpos < window);
          sc[4 * x + e] = keep0 ? sc[4 * x + e] : FA_NEG_INF;
          sc[4 * x + 2 + e] = keep1 ? sc[4 * x + 2 + e] : FA_NEG_INF;
        }
        if (!edge || col < bk) {
          mx0 = fmaxf(mx0, sc[4 * x + e]);
          mx1 = fmaxf(mx1, sc[4 * x + 2 + e]);
        }
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);

    // the corrections; O rescaled while no product is in flight, then the
    // next sub-block's S products issued to run beside P = exp(S - m)
    const float cr0 = expf(m0 - mn0), cr1 = expf(m1 - mn1);
    if (__any_sync(0xffffffffu, cr0 != 1.f || cr1 != 1.f)) {   // x 1 is exact: skipped
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        o[4 * x] *= cr0; o[4 * x + 1] *= cr0;
        o[4 * x + 2] *= cr1; o[4 * x + 3] *= cr1;
      }
    }
    fence_regs(o);   // the rescale stays ahead of the next S products
    if (j + 1 < n_sub)
      fa_h256_s(sn, qa, kwg + ((j + 1) % D) * FA_H_STAGE, &kfull[(j + 1) % D], ((j + 1) / D) & 1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !edge || h * FA_H_SUB + x * 8 + 2 * t + e < bk;
        const float p0 = valid ? expf(sc[4 * x + e] - mn0) : 0.f;
        const float p1 = valid ? expf(sc[4 * x + 2 + e] - mn1) : 0.f;
        sc[4 * x + e] = p0;
        sc[4 * x + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    l0 = cr0 * l0 + sum0;
    l1 = cr1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // O[:, this half] += P V[:, this half]: P's fragment columns t and t+4
    // are S columns 2t, 2t+1
    uint32_t pa[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[x][0] = to_tf32(sc[4 * x]);
      pa[x][1] = to_tf32(sc[4 * x + 2]);
      pa[x][2] = to_tf32(sc[4 * x + 1]);
      pa[x][3] = to_tf32(sc[4 * x + 3]);
    }
    mbar_wait(&vfull[s], (j / D) & 1);
    wgmma_fence();
    const uint64_t dv = desc_sw128(Vs + s * FA_H_STAGE + wg * 128 * HOP_ROW_BYTES);
#pragma unroll
    for (int x = 0; x < 4; ++x) wgmma_m64n128k8_rs(o, pa[x], dv + 2 * x, 1);
    wgmma_commit();
    // the stages the first barrier freed, refilled while P V runs
    if (loader) {
      if (j + D < n_sub) load_k(j + D);
      if (j + D - 1 < n_sub) load_v(j + D - 1);
    }

    // noise slot of the live block, once, overlapping its last P V products
    if (h == nsub - 1) {
      const int step = bh * 131 + qi * 17 + ki;
      if constexpr (MODE == MODE_FP) fp_noise<SK>(acc, fc, kn);
      else if constexpr (MODE == MODE_VMEM) vmem_noise<FA_H_SLOT_SK(SK)>(acc, Ns, REPRO_NZ_STRIDE, 128, 128, step, kn, tid);
      else if constexpr (MODE == MODE_MXU) mxu_noise_lean<FA_H_SLOT_SK(SK)>(acc, Ns, REPRO_NZ_STRIDE, kn, tid);
    }
  }
  wgmma_wait<0>();
  fence_regs(o);

  // out[:, this half] = O / l (both warpgroups hold the same l)
  const float sf0 = l0 == 0.f ? 1.f : l0, sf1 = l1 == 0.f ? 1.f : l1;
  T* orow = out + ((size_t)bh * Sq + q0) * HD + wg * 128;
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const int col = x * 8 + 2 * t;
    if (r0 < bq) Elem<T>::store2(orow + (size_t)r0 * HD + col, o[4 * x] / sf0, o[4 * x + 1] / sf0);
    if (r1 < bq)
      Elem<T>::store2(orow + (size_t)r1 * HD + col, o[4 * x + 2] / sf1, o[4 * x + 3] / sf1);
  }
  write_partial<MODE>(partials + ((size_t)bh * nq + qi) * REPRO_NACC, acc, tid);
}

// kp, vt: f32 scratch of B*KH*(Sk/bk)*64*256 floats each
template <typename T, int MODE, int SK>
static cudaError_t launch_fa_h256(const void* q, const void* k, const void* v,
                                  const float* noise, void* out, float* kp, float* vt,
                                  float* partials, float* scratch, float* nacc, int B, int H,
                                  int KH, int Sq, int Sk, int bq, int bk, int causal, int window,
                                  int smem, int kn, cudaStream_t st) {
  constexpr int HD = 256;
  if (smem != fa_h256_bytes<MODE>()) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fa_kernel_h256<T, MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  const int nk = Sk / bk, blocks = B * KH * nk;
  CUtensorMap tk, tv;
  if ((e = make_map_f32(&tk, kp, HD, blocks * FA_BLOCK, FA_H_SUB)) != cudaSuccess) return e;
  if ((e = make_map_f32(&tv, vt, FA_BLOCK, blocks * HD, HD / 2)) != cudaSuccess) return e;
  // a prep of 16 kv blocks or fewer (seq 24 at B = 2, KH = 2: 4) takes their
  // rows in halves as well: one block a kv block took 0.006 ms there, and
  // halving the rows of gemma-2b's 64 slowed the attention kernel after it
  // by 4% (H100)
  fa_prep<T, HD><<<dim3(blocks, HD / 128, blocks <= 16 ? 2 : 1), REPRO_THREADS, 0, st>>>(
      (const T*)k, (const T*)v, kp, vt, Sk, bk, nk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the reference's scale: 1.0 / math.sqrt(hd) in double, used as an f32
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  const int n_cta = B * H * (Sq / bq);
  fa_kernel_h256<T, MODE, SK><<<n_cta, REPRO_THREADS, smem, st>>>(
      tk, tv, (const T*)q, noise, (T*)out, partials, H, KH, Sq, Sk, bq, bk, causal, window, scale,
      kn);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_partials(partials, n_cta, scratch, nacc, st);
}

// dtype: 0 = float32, 1 = bfloat16; hd 64 and 128 take fa_kernel_wgmma,
// hd 256 fa_kernel_h256
template <int MODE, int SK>
static cudaError_t dispatch_fa(const void* q, const void* k, const void* v, const float* noise,
                               void* out, float* kp, float* vt, float* partials, float* scratch,
                               float* nacc, int B, int H, int KH, int Sq, int Sk, int hd, int bq,
                               int bk, int causal, int window, int dtype, int smem, int kn,
                               cudaStream_t st) {
#define FA_CASE(TYPE, HDV)                                                                       \
  if constexpr (HDV == 256)                                                                      \
    return launch_fa_h256<TYPE, MODE, SK>(q, k, v, noise, out, kp, vt, partials, scratch, nacc, B, \
                                          H, KH, Sq, Sk, bq, bk, causal, window, smem, kn, st);   \
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

// kp, vt: scratch for the kernels' K and V^T;
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
