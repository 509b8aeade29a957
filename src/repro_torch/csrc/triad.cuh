// The STREAM triad chunk, c = a + 3 b, shared by the two triad loops:
// stream_kernel (loop_regions.cu, the Sec. 4 STREAM region) and the stream
// scenarios of t3_kernel (decan_loops.cu, Table 3's data-bound and
// full-overlap loops). One warp runs one chunk, as one reference iteration.
//
// What bounds it: device memory, 12 bytes an element (a and b read once, c
// written once), 0.1202 ms at n = 2^25 on the H100's 3.35 TB/s; the chains
// of Table 3's data-bound scenario (48 FP32 operations a lane and
// iteration) must hide under the loads. Nothing is re-read, so shared
// memory and the L2 cannot cut the bytes.
//
// What held the old loops back (tools/torch_triad_bench.py on the card):
// not bytes in flight. stream_kernel's element loop had a run-time trip
// count (nvcc unrolled it 4 times with a remainder ladder, two a/b pairs of
// 16-byte loads ahead of the stores) and t3's took an integer modulo
// (I2F.RP, MUFU.RCP, IMAD.HI) an iteration, yet both clean loops cost the
// same. Two things keep both above torch.add's time:
// * the grouping: 4,224 persistent warps (loop_regions/ref.py N_WARPS_MAX)
//   each walk a fixed share of the chunks, and nothing rebalances the SMs'
//   shares of the bandwidth; the same loop walked by 16,384-32,768 warps,
//   which the block scheduler balances, ran ~3% faster. The grouping stays:
//   it decides each warp's noise carry, and with fewer chunks a warp less
//   of a warp's noise slot has loads of its own to hide under (chase at
//   k = 8 cost twice as much over k = 0 at 32,768 warps as at 4,224);
// * the block epilogue (block sums and the ticket, reduce_blocks): a
//   timing-only copy without it ran at torch.add's time.
//
// What this does:
// * `Triad512::load` issues all 8 of a lane's 16-byte loads of a chunk
//   (float4s lane, lane+32, lane+64, lane+96 of a and of b) before any
//   arithmetic, and `Triad512::advance` stores the chunk in flight, then
//   puts the warp's next chunk in flight in the same registers before the
//   noise slot runs (64 registers a thread: 4 blocks of 256 an SM, the
//   grid's 528 blocks in one wave; a second buffer took 76). The caller's
//   iteration loop stays one reference iteration per machine iteration
//   (#pragma unroll 1), so a static-k build still holds k patterns;
// * the loads are read-only (ld.global.nc) and the stores plain:
//   evict-first (.cs) loads were no faster;
// * t3's offset is stepped, not taken modulo (decan_loops.cu);
// * the data stays on the load/store units (LDG/STG, no TMA or bulk copy),
//   where l1_ld and mem_ld noise competes with it as in the reference's
//   loop.
// All arithmetic is __fmul_rn / __fadd_rn (no FFMA): the plain versions
// round each operation, and the outputs are bitwise theirs.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define TRIAD_CHUNK 512
#define TRIAD_VECS (TRIAD_CHUNK / 4 / 32)   // float4s of a chunk per lane

__device__ __forceinline__ float4 triad4(const float4& x, const float4& y) {
  float4 z;
  z.x = __fadd_rn(x.x, __fmul_rn(3.f, y.x));
  z.y = __fadd_rn(x.y, __fmul_rn(3.f, y.y));
  z.z = __fadd_rn(x.z, __fmul_rn(3.f, y.z));
  z.w = __fadd_rn(x.w, __fmul_rn(3.f, y.w));
  return z;
}

// One warp's 512-float chunk in flight: lane l holds float4s l + 32 q of a
// and of b (q < 4), so each of its 8 loads is a warp-wide 512-byte line run.
struct Triad512 {
  float4 x[TRIAD_VECS], y[TRIAD_VECS];

  __device__ __forceinline__ void load(const float* a, const float* b, size_t off, int lane) {
    const float4* a4 = reinterpret_cast<const float4*>(a + off) + lane;
    const float4* b4 = reinterpret_cast<const float4*>(b + off) + lane;
#pragma unroll
    for (int q = 0; q < TRIAD_VECS; ++q) {
      x[q] = __ldg(a4 + 32 * q);
      y[q] = __ldg(b4 + 32 * q);
    }
  }

  // c[off:off+512] = a + 3 b of the chunk in flight, then, when `more`,
  // the chunk at `next` goes in flight into the same registers (the
  // stores issue first: a second buffer would take more than the 64
  // registers a thread that keep 4 blocks of 256 on each SM)
  __device__ __forceinline__ void advance(const float* a, const float* b, float* c, size_t off,
                                          size_t next, bool more, int lane) {
    float4* c4 = reinterpret_cast<float4*>(c + off) + lane;
#pragma unroll
    for (int q = 0; q < TRIAD_VECS; ++q) c4[32 * q] = triad4(x[q], y[q]);
    if (more) load(a, b, next, lane);
  }
};

// Any other chunk length: float4s when it is a multiple of 4, else floats,
// lane-strided
__device__ __forceinline__ void triad_generic(const float* a, const float* b, float* c, size_t off,
                                              int chunk, int lane) {
  if ((chunk & 3) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a + off);
    const float4* b4 = reinterpret_cast<const float4*>(b + off);
    float4* c4 = reinterpret_cast<float4*>(c + off);
#pragma unroll 1
    for (int e = lane; e < chunk / 4; e += 32) c4[e] = triad4(__ldg(a4 + e), __ldg(b4 + e));
  } else {
#pragma unroll 1
    for (int e = lane; e < chunk; e += 32)
      c[off + e] = __fadd_rn(__ldg(a + off + e), __fmul_rn(3.f, __ldg(b + off + e)));
  }
}
