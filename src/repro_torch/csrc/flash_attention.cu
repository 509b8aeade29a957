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
// What bounds it on the H100: operations. Per live (bq=64, bk=64) block at
// hd=128 there are two products of 2*64*64*128 = 1.05 MFLOP; Qwen3-30B-A3B's
// attention (B=1, H=32, KH=4, S=4096, causal) has 32 x 2080 live blocks,
// 1.40e11 operations, 0.28 ms at the 495 TFLOP/s TF32 dense peak. Its bytes
// (q + out 128 MiB, k + v 16 MiB) take 0.045 ms at 3.35 TB/s.
//
// Design (simple first; wgmma, TMA and a pipelined K/V ring come later):
// * One CTA per (bh, qi), 256 threads = 8 warps, a loop over the live kv
//   blocks ki inside the CTA in place of Pallas's sequential kv grid axis.
//   CTAs are issued heaviest-first (largest qi) so causal tails overlap.
//   Running max and sum live in shared memory, one float per row; the
//   output accumulator lives in registers as mma C fragments (warp w owns
//   rows 16*(w%4).. and half of the hd columns).
// * S = Q K^T and O += P V run on the tensor cores: mma.sync m16n8k8 TF32
//   with f32 accumulation (the fragment code of noisy_matmul.cu), the fair
//   counterpart of the TPU's default-precision f32 dot. Softmax runs in IEEE
//   f32 (expf), four threads per row.
// * Shared memory: Q (scaled, f32) 64 x (hd+4), one K/V buffer 64 x (hd+8)
//   that holds K for S and then V for P V, S/P 64 x 68, and for mxu/vmem
//   the 128 x 132 noise operand: 151 KiB at hd=128, 215 KiB at hd=256 (opt
//   in with cudaFuncSetAttribute). bf16 q/k/v are widened to f32 when they
//   are staged, as astype(float32) does.
// * Blocks smaller than 64 (seq 8..63) are padded: spare Q/K/V rows are
//   zero, spare S columns take no part in the max and get p = 0, spare
//   output rows are not stored.
// * Noise goes into the CTA's (8,128) partial once per live block; the
//   partials (4 KiB per CTA, 8 MiB at the main shape) are summed by
//   nacc_reduce in CTA order (bh*nq + qi), so static and runtime k agree
//   bitwise and the plain version can follow the same order.
#include <cuda_bf16.h>

#include <cmath>

#include "noise_slots.cuh"

#define FA_BLOCK 64       // the largest bq and bk the kernel takes
#define FA_SS 68          // S/P row stride (floats): A-fragment reads conflict-free
#define FA_NEG_INF -1e30f

template <int HD> __host__ __device__ constexpr int fa_qs() { return HD + 4; }   // Q row stride
template <int HD> __host__ __device__ constexpr int fa_kvs() { return HD + 8; }  // K/V row stride

template <int HD, int MODE>
constexpr int fa_smem_bytes() {
  return (FA_BLOCK * fa_qs<HD>() + FA_BLOCK * fa_kvs<HD>() + FA_BLOCK * FA_SS + 3 * FA_BLOCK +
          ((MODE == MODE_MXU || MODE == MODE_VMEM) ? 128 * REPRO_NZ_STRIDE : 0)) *
         (int)sizeof(float);
}

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
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
static cudaError_t launch_fa(const void* q, const void* k, const void* v, const float* noise,
                             void* out, float* partials, float* scratch, float* nacc, int B,
                             int H, int KH, int Sq, int Sk, int bq, int bk, int causal,
                             int window, int kn, cudaStream_t st) {
  const int smem = fa_smem_bytes<HD, MODE>();
  cudaError_t e = allow_smem(fa_kernel<T, HD, MODE, SK>, smem);
  if (e != cudaSuccess) return e;
  // the reference's scale: 1.0 / math.sqrt(hd) in double, used as an f32
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  const int n_cta = B * H * (Sq / bq);
  fa_kernel<T, HD, MODE, SK><<<n_cta, REPRO_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, noise, (T*)out, partials, H, KH, Sq, Sk, bq, bk,
      causal, window, scale, kn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_partials(partials, n_cta, scratch, nacc, st);
}

// dtype: 0 = float32, 1 = bfloat16
template <int MODE, int SK>
static cudaError_t dispatch_fa(const void* q, const void* k, const void* v, const float* noise,
                               void* out, float* partials, float* scratch, float* nacc, int B,
                               int H, int KH, int Sq, int Sk, int hd, int bq, int bk, int causal,
                               int window, int dtype, int kn, cudaStream_t st) {
#define FA_CASE(TYPE, HDV)                                                                      \
  return launch_fa<TYPE, HDV, MODE, SK>(q, k, v, noise, out, partials, scratch, nacc, B, H, KH, \
                                        Sq, Sk, bq, bk, causal, window, kn, st)
#ifdef REPRO_STATIC_HD   // a static-k build holds the one variant it was built for
  if (hd != REPRO_STATIC_HD || dtype != REPRO_STATIC_BF16) return cudaErrorInvalidValue;
#if REPRO_STATIC_BF16
  FA_CASE(__nv_bfloat16, REPRO_STATIC_HD);
#else
  FA_CASE(float, REPRO_STATIC_HD);
#endif
#else
  if (dtype == 0) {
    if (hd == 64) FA_CASE(float, 64);
    if (hd == 128) FA_CASE(float, 128);
    if (hd == 256) FA_CASE(float, 256);
  } else if (dtype == 1) {
    if (hd == 64) FA_CASE(__nv_bfloat16, 64);
    if (hd == 128) FA_CASE(__nv_bfloat16, 128);
    if (hd == 256) FA_CASE(__nv_bfloat16, 256);
  }
  return cudaErrorInvalidValue;
#endif
#undef FA_CASE
}

#ifdef REPRO_STATIC_K
extern "C" int repro_attention_static(const void* q, const void* k, const void* v,
                                      const float* noise, void* out, float* partials,
                                      float* scratch, float* nacc, int B, int H, int KH, int Sq,
                                      int Sk, int hd, int bq, int bk, int causal, int window,
                                      int dtype, void* stream) {
  return (int)dispatch_fa<REPRO_STATIC_MODE, REPRO_STATIC_K>(
      q, k, v, noise, out, partials, scratch, nacc, B, H, KH, Sq, Sk, hd, bq, bk, causal, window,
      dtype, REPRO_STATIC_K, (cudaStream_t)stream);
}
#else
extern "C" int repro_attention_rt(const void* q, const void* k, const void* v, const float* noise,
                                  void* out, float* partials, float* scratch, float* nacc, int B,
                                  int H, int KH, int Sq, int Sk, int hd, int bq, int bk,
                                  int causal, int window, int dtype, int mode, int kn,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  kn = clip_k(kn);
#define FA_MODE(M)                                                                           \
  return (int)dispatch_fa<M, -1>(q, k, v, noise, out, partials, scratch, nacc, B, H, KH, Sq, \
                                 Sk, hd, bq, bk, causal, window, dtype, kn, st)
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
