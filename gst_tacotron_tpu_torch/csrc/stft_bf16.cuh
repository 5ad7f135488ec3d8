// The tensor-core mel-STFT of a wav on bf16 operands, the kernel of K3's bf16
// mode (stft_features.cu, MB = true) and of K3′'s bf16_bases mode
// (stft_fused.cu, MB = false): the frames and the window-baked cos/sin
// bases rounded to bfloat16, their products summed in float32 (the TPU
// kernels' MXU form; no FFT computes this function), the magnitude in
// float32. The mel sums each filter's nonzero bins in ascending order, in
// float32: of the float32 magnitudes (MB = false), or of the magnitudes and
// the filter weights rounded to bfloat16 (MB = true: the resident Pallas
// kernel's bf16 mel product).
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch,
// n_fft 2048, n_live 1024, 1025 bins, 80 mels): the two dense products,
// 2 * 2 * n_live * NF FLOPs a frame, 4.3 GFLOP a launch, about 4.4 us at
// the 989 TFLOP/s of the bf16 tensor cores (the bytes, about 1.7 us, do not
// bound it). The bases (n_live x 1152 bins x 2, 4.7 MB in bf16) are read
// by every frame tile, so the design is about how often they cross from L2.
//
// Design (an implicit GEMM per launch: frames x taps against taps x bins):
// - a CTA owns a tile of 64 frames (one wgmma m64 row tile) of one
//   utterance and a window of 144 bins (8 windows cover the
//   1025 bins of n_fft 2048); a cluster of cw CTAs owns the tile's windows
//   (cw = 8 at the main shape: 16 tiles x 8 = 128 CTAs a launch, and each
//   byte of the bases crosses 16 times a launch, not 64);
// - a ring of 2 stages of 64 taps x 144 bins of cos and sin bases filled
//   by TMA (cp.async.bulk.tensor, 128-byte swizzle, completed on
//   mbarriers; thread 0 refills a slot once every warp released it); the
//   host lays the bases out K-major as the tensor map and wgmma want
//   (ops/stft.py::wgmma_bases). A CTA takes 108 KB of shared memory and
//   256 threads of at most 128 registers, so two share an SM and the 16
//   clusters of 8 of the main shape run in one wave (one CTA an SM fits
//   only 15 clusters of 8 on the H100), each CTA's latency-bound phases
//   (staging, epilogue, gather, mel) overlapping its neighbour's mainloop;
// - two warpgroups, each wgmma.m64n72k16 twice a k16 step (cos, sin) over
//   its half of the window's bins, with A in registers, read
//   from the tile's wav span staged once in
//   shared memory as bf16: frame r's tap k is sample r * hop + k, so a
//   64-frame span is 63 * hop + n_live samples (34 KB at the main shape),
//   not 64 frames (the 4x overlap of hop 256 is read once). The span's
//   hop-long segments are stored at a stride S = hop + pad with
//   S = 8 (mod 64), so the 8 rows of a fragment hit 8 bank groups. Where
//   the span does not fit (or hop is odd), each frame's taps are staged
//   as rows of a chunk of kch taps instead (ops/stft.py::bf16_plan);
// - the linear rows are written from the accumulators; the magnitudes
//   stay in shared memory (the ring, free after the mainloop), where each
//   CTA takes its window's share of every mel filter: in the bf16 mode
//   (MB) a tensor-core product of the bf16 magnitudes and the window's
//   rows of the bf16 mel basis (mma.sync, float32 sums), else each
//   filter's nonzero bins of the window in ascending order; after a cluster
//   barrier each CTA adds, for 64 / cw frames, each filter's window
//   partials in ascending order from the CTAs that own them (distributed
//   shared memory; 1-3 windows a filter at the main shape). Past 8 windows
//   (n_fft > 2302) each CTA walks several windows and the magnitudes go
//   through a device-memory scratch instead (the cluster barrier orders
//   it), each filter summed whole. The dB maps run log2 on the special-
//   function unit. One launch, no atomics, the same bits every run.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <string.h>

#include "stft_wav.cuh"

namespace cg = cooperative_groups;

#define BW_TM 64                       // frames a tile: wgmma m64
#define BW_WN 144                      // bins a window: wgmma n144
#define BW_KB 64                       // taps a ring stage: one 128-byte swizzle row
#define BW_BOX (BW_WN * BW_KB * 2)     // bytes of one product's stage (18432)
#define BW_STAGE (2 * BW_BOX)          // cos + sin
#define BW_MS (BW_WN + 2)              // a magnitude row's stride in floats (2-way banks)
#define BW_HN 72                       // bins of a window a warpgroup: wgmma n72
#define BW_THREADS 256                 // two warpgroups
#define BW_MAX_CW 8

// ops/stft.py::bf16_plan, in this order
struct Bf16Plan {
  int windows;   // 144-bin windows
  int cw;        // CTAs a cluster (a power of two, <= 8)
  int kp;        // taps padded to a multiple of BW_KB
  int span;      // 1: the wav span (stride S); 0: rows of kch taps (stride kch + 8)
  int stride;    // S or kch + 8, in bf16
  int kch;       // taps a staged chunk (row mode)
  int stages;    // ring stages
  int scratch;   // 1: magnitudes through the device-memory scratch
  int a_bytes;   // the staged taps' bytes
  int smem;      // dynamic shared memory, 1 KB of alignment slack included
  int mel_nt;    // n8 tiles of the tensor-core mel product (MB; 0: the filters' sums)
  int mel_frag;  // where its B fragments start in the tables, in uint2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one box of the 2-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile in shared memory written by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart (the stride offset); the leading offset is unused for this layout.
// A k16 step inside the 64-tap row adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 72, float32, the warpgroup's fragments) += a (64 x 16 bf16, in
// registers: warp w of the warpgroup holds rows 16w..16w+15 in
// mma.m16n8k16's A layout) * the 16 x 72 K-major tile at `desc`
__device__ __forceinline__ void wgmma_n72(float (&d)[36], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// db_normalize with the logarithm on the special-function unit (20 log10 x
// = 20 log10(2) * log2 x) and the range's division as a product: within
// 1e-6 dB of it
__device__ __forceinline__ float db_fast(float x, NormConsts c, float inv_range) {
  const float db = 6.0205999f * __log2f(fmaxf(x, 1e-5f)) - c.ref_db;
  const float unit = (db - c.min_db) * inv_range;
  if (c.symmetric)
    return fminf(fmaxf(2.0f * c.max_abs * unit - c.max_abs, -c.max_abs), c.max_abs);
  return fminf(fmaxf(unit, 0.0f), 1.0f);
}

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16f(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Grid (tiles * cw, B) in clusters of (cw, 1, 1): the cluster owns frames
// [tile * 64, tile * 64 + 64) of utterance blockIdx.y, CTA `rank` of it the
// windows [rank * wpc, (rank + 1) * wpc) and the mel of frames
// [rank * fpr, (rank + 1) * fpr). Warpgroup h computes the bins
// [72h, 72h + 72) of each window; thread 0 also starts the bases' TMA
// loads. SPAN: the staged taps are the wav span (else chunks of rows).
template <bool MB, bool SPAN>
__global__ void __launch_bounds__(BW_THREADS, 2)
stft_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap bases,  // (2 * windows * 144, kp)
                       const uint2* __restrict__ melb,  // (windows, mel_nt, 9, 32) fragments
                       const float* __restrict__ wav,               // (B, L)
                       const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                       const float* __restrict__ mel_w,
                       float* __restrict__ mel_out,       // (B, T, M)
                       float* __restrict__ lin_out,       // (B, T, NF)
                       float* __restrict__ mag_scratch,   // (B, T, windows * 144) if p.scratch
                       int L, int T, int hop, int n0, int n_live, int NF, int M,
                       NormConsts nc, int normalize_linear, Bf16Plan p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cw = p.cw, rank = (int)cluster.block_rank();
  const int wpc = (p.windows + cw - 1) / cw, fpr = (BW_TM + cw - 1) / cw;
  const int wbeg = min(p.windows, rank * wpc), wend = min(p.windows, wbeg + wpc);
  const int nfw = p.windows * BW_WN;  // a full magnitude row
  const int ksteps = p.kp / BW_KB, stages = p.stages;
  const float inv_range = 1.0f / -nc.min_db;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  // the ring; after the mainloop (every stage consumed) it holds the
  // magnitude tile, then the mel's partial sums (64 x M)
  uint8_t* ring = base;                                          // stages x BW_STAGE
  float* mags = reinterpret_cast<float*>(ring);                  // 64 x BW_MS
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(ring + (size_t)stages * BW_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(As) + p.a_bytes);
  uint64_t* empty = full + stages;

  const int b = blockIdx.y, t0 = (blockIdx.x / cw) * BW_TM;
  const int frames = min(BW_TM, T - t0);
  const size_t row0 = (size_t)b * T + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the span's float32 samples go through the ring before the first bases
  // (cp.async, every copy in flight at once)
  const int nseg = BW_TM + (p.kp - 1) / hop;
  const bool via_ring = SPAN && nseg * hop * 4 <= stages * BW_STAGE;
  const int total = (wend - wbeg) * ksteps;  // the CTA's ring stages, window-major
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BW_THREADS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage `it` of the window-major walk into its slot (thread 0)
  auto load_stage = [&](int it) {
    const int slot = it % stages, win = wbeg + it / ksteps, ks = it % ksteps;
    mbar_expect_tx(&full[slot], BW_STAGE);
    uint8_t* dst = ring + (size_t)slot * BW_STAGE;
    tma_load_2d(dst, &bases, ks * BW_KB, win * BW_WN, &full[slot]);
    tma_load_2d(dst + BW_BOX, &bases, ks * BW_KB, nfw + win * BW_WN, &full[slot]);
  };
  if (threadIdx.x == 0 && !via_ring)
    for (int it = 0; it < min(stages, total); ++it) load_stage(it);

  {
    const float* w = wav + (size_t)b * L;
    const int tid = threadIdx.x, cwarp = warp & 3, half = warp >> 2;
    const int S = p.stride;
    // stage the taps: the span (segments of hop samples at stride S), or
    // chunk c of every frame's taps as rows of kch (stride S); zero past
    // the wav and the live taps (the bases are zero there, but the values
    // must be finite). A warp a segment or row, its lanes along it; 4
    // loads in flight a lane where they go through registers.
    auto load_span = [&]() {
      const size_t s0 = (size_t)t0 * hop + n0;
      if (via_ring) {
        float* fs = reinterpret_cast<float*>(ring);
        for (int i = tid; i < nseg * hop; i += BW_THREADS)
          cp_async4_zfill(fs + i, w + (s0 + i < (size_t)L ? s0 + i : 0), s0 + i < (size_t)L);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        // even hop and stride: two samples a 32-bit store
        for (int seg = warp; seg < nseg; seg += BW_THREADS / 32)
          for (int e = 2 * lane; e < hop; e += 64)
            *reinterpret_cast<__nv_bfloat162*>(As + seg * S + e) =
                __floats2bfloat162_rn(fs[seg * hop + e], fs[seg * hop + e + 1]);
        return;
      }
      for (int seg = warp; seg < nseg; seg += BW_THREADS / 32)
        for (int e0 = lane; e0 < hop; e0 += 4 * 32) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t s = s0 + (size_t)seg * hop + e0 + 32 * j;
            v[j] = e0 + 32 * j < hop && s < (size_t)L ? __ldg(w + s) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (e0 + 32 * j < hop) As[seg * S + e0 + 32 * j] = __float2bfloat16_rn(v[j]);
        }
    };
    auto load_chunk = [&](int c) {
      for (int r = warp; r < BW_TM; r += BW_THREADS / 32)
        for (int e0 = lane; e0 < p.kch; e0 += 4 * 32) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = e0 + 32 * j, k = c * p.kch + e;
            const size_t s = (size_t)(t0 + r) * hop + n0 + k;
            v[j] = e < p.kch && k < n_live && s < (size_t)L ? __ldg(w + s) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (e0 + 32 * j < p.kch) As[r * S + e0 + 32 * j] = __float2bfloat16_rn(v[j]);
        }
    };
    const int chunks = SPAN ? 1 : (p.kp + p.kch - 1) / p.kch;
    if (wbeg < wend) {
      if (SPAN)
        load_span();
      else if (chunks == 1)
        load_chunk(0);
      __syncthreads();
      if (via_ring && tid == 0)  // the ring is free again
        for (int it = 0; it < min(stages, total); ++it) load_stage(it);
    }
    const int g = lane >> 2, t = lane & 3, r0 = cwarp * 16 + g;  // rows r0, r0 + 8
    const int boff = half * BW_HN * 128;  // this warpgroup's 72 rows of each box
    int it = 0;
    for (int win = wbeg; win < wend; ++win) {
      float ac[36], as[36];
#pragma unroll
      for (int i = 0; i < 36; ++i) ac[i] = as[i] = 0.0f;
      // this thread's taps 2t and 2t + 8 of the k16 step: (segment, offset)
      // in the span, or the offset in the chunk's rows
      int qa = (2 * t) / hop, ra = (2 * t) % hop, qb = (2 * t + 8) / hop, rb = (2 * t + 8) % hop;
      int kl = 0;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        if (!SPAN && chunks > 1 && (ks * BW_KB) % p.kch == 0) {
          __syncthreads();  // every thread is done with the previous chunk
          load_chunk(ks * BW_KB / p.kch);
          __syncthreads();
          kl = 0;
        }
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (SPAN) {
            const __nv_bfloat16* pa = As + (r0 + qa) * S + ra;
            const __nv_bfloat16* pb = As + (r0 + qb) * S + rb;
            a[s][0] = ld_b32(pa);
            a[s][1] = ld_b32(pa + 8 * S);
            a[s][2] = ld_b32(pb);
            a[s][3] = ld_b32(pb + 8 * S);
            ra += 16;
            while (ra >= hop) ra -= hop, ++qa;
            rb += 16;
            while (rb >= hop) rb -= hop, ++qb;
          } else {
            const __nv_bfloat16* pa = As + r0 * S + kl + 2 * t;
            a[s][0] = ld_b32(pa);
            a[s][1] = ld_b32(pa + 8 * S);
            a[s][2] = ld_b32(pa + 8);
            a[s][3] = ld_b32(pa + 8 * S + 8);
            kl += 16;
          }
        }
        const int slot = it % stages, use = it / stages;
        mbar_wait(&full[slot], use & 1);
        const uint64_t dc = sw128_desc(ring + (size_t)slot * BW_STAGE + boff);
        const uint64_t dsn = sw128_desc(ring + (size_t)slot * BW_STAGE + BW_BOX + boff);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wgmma_n72(ac, a[s], dc + 2 * s);
          wgmma_n72(as, a[s], dsn + 2 * s);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (tid == 0 && it + stages < total) {  // refill the slot once every warp is done
          mbar_wait(&empty[slot], use & 1);
          load_stage(it + stages);
        }
      }
      if (!p.scratch) __syncthreads();  // no wgmma of either warpgroup still reads the ring
      // magnitudes: fragment 4j + i of a product is row r0 + 8 * (i / 2),
      // bin 72 * half + 8j + 2t + i % 2 of the window. Each thread writes
      // its pairs to the linear rows (32 bytes a row for a lane quad) and to
      // the mel's source: the magnitude tile, or past 8 windows the scratch.
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h, r = r0 + 8 * h, c = half * BW_HN + 8 * j + 2 * t;
          const int bin = win * BW_WN + c;
          const float2 m2 = make_float2(sqrtf(ac[i] * ac[i] + as[i] * as[i]),
                                        sqrtf(ac[i + 1] * ac[i + 1] + as[i + 1] * as[i + 1]));
          if (!p.scratch) *reinterpret_cast<float2*>(mags + r * BW_MS + c) = m2;
          if (r < frames) {
            float* lr = lin_out + (row0 + r) * NF + bin;
            const float l0 = normalize_linear ? db_fast(m2.x, nc, inv_range) : m2.x;
            const float l1 = normalize_linear ? db_fast(m2.y, nc, inv_range) : m2.y;
            if (bin < NF) lr[0] = l0;
            if (bin + 1 < NF) lr[1] = l1;
            if (p.scratch)
              *reinterpret_cast<float2*>(mag_scratch + (row0 + r) * nfw + bin) = m2;
          }
        }
    }
  }

  if (!p.scratch) {
    // the mel, one window a CTA: each filter's partial sum over this CTA's
    // window for all 64 rows, into the ring past the tile
    float* part = mags + BW_TM * BW_MS;  // 64 x M
    if (MB && p.mel_nt > 0 && wbeg < wend) {
      // the bf16 mel product on the tensor cores: the window's magnitudes
      // rounded to bf16 (A, 64 x 144) times its rows of the mel basis in
      // bf16 (B fragments from the host), float32 sums; warp w the rows
      // 16 (w % 4).. and half of the mel's n8 tiles
      const int g = lane >> 2, t = lane & 3, r0 = (warp & 3) * 16 + g;
      const int nh = (p.mel_nt + 1) / 2, nt0 = (warp >> 2) * nh;
      const int ntl = min(nh, p.mel_nt - nt0);
      const uint2* fb = melb + ((size_t)wbeg * p.mel_nt + nt0) * 9 * 32 + lane;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
      auto pack = [&](int r, int c) {
        const float2 v = *reinterpret_cast<const float2*>(mags + r * BW_MS + c);
        const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
        return *reinterpret_cast<const uint32_t*>(&h);
      };
#pragma unroll 3
      for (int s = 0; s < 9; ++s) {
        const uint32_t a[4] = {pack(r0, 16 * s + 2 * t), pack(r0 + 8, 16 * s + 2 * t),
                               pack(r0, 16 * s + 2 * t + 8), pack(r0 + 8, 16 * s + 2 * t + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < ntl) mma_bf16_16816(acc[j], a, __ldg(fb + ((size_t)j * 9 + s) * 32));
      }
      // fragment i of n8 tile j: row r0 + 8 * (i / 2), filter (nt0 + j) * 8 + 2t + i % 2
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = (nt0 + j) * 8 + 2 * t + i % 2;
          if (j < ntl && m < M) part[(r0 + 8 * (i / 2)) * M + m] = acc[j][i];
        }
    } else if (wbeg < wend) {
      // each filter's partial sum over this CTA's window (its nonzero bins
      // there in ascending order), float32 (or on bf16 operands past 128
      // mels); a warp's lanes are rows of one filter
      const int b0 = wbeg * BW_WN;
      for (int e = threadIdx.x; e < BW_TM * M; e += BW_THREADS) {
        const int m = e / BW_TM, r = e - m * BW_TM;
        const int lo = mel_lo[m], j0 = mel_off[m], n = mel_off[m + 1] - j0;
        const int c0 = max(lo, b0), c1 = min(lo + n, b0 + BW_WN);
        const float* mg = mags + r * BW_MS - b0;
        const float* mw = mel_w + j0 - lo;
        float acc = 0.0f;
#pragma unroll 4
        for (int c = c0; c < c1; ++c)
          acc = fmaf(MB ? round_bf16f(mg[c]) : mg[c], MB ? round_bf16f(__ldg(mw + c)) : __ldg(mw + c),
                     acc);
        part[r * M + m] = acc;
      }
    }
    cluster.sync();  // every CTA's partial sums are in its shared memory
    // this CTA's frames: each filter's window partials in ascending order
    for (int e = threadIdx.x; e < fpr * M; e += BW_THREADS) {
      const int rl = e / M, m = e - rl * M, r = rank * fpr + rl;
      if (r >= frames) continue;
      const int lo = mel_lo[m], n = mel_off[m + 1] - mel_off[m];
      const int w0 = lo / BW_WN, w1 = n > 0 ? (lo + n - 1) / BW_WN : w0 - 1;
      float v[BW_MAX_CW];  // one window a CTA here: at most 8
#pragma unroll
      for (int k = 0; k < BW_MAX_CW; ++k)  // the remote loads in flight together
        v[k] = w0 + k <= w1 ? cluster.map_shared_rank(part, w0 + k)[r * M + m] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < BW_MAX_CW; ++k)
        if (w0 + k <= w1) acc += v[k];
      mel_out[(row0 + r) * M + m] = db_fast(acc, nc, inv_range);
    }
    cluster.sync();  // the peers are done reading this CTA's partial sums
    return;
  }
  // past 8 windows: this CTA's frames from the scratch, each filter's
  // nonzero bins in ascending order
  __threadfence();
  cluster.sync();  // every CTA's magnitudes are in the scratch
  for (int e = threadIdx.x; e < fpr * M; e += BW_THREADS) {
    const int rl = e / M, m = e - rl * M, r = rank * fpr + rl;
    if (r >= frames) continue;
    const float* mg = mag_scratch + (row0 + r) * nfw + mel_lo[m] - mel_off[m];
    const int j0 = mel_off[m], j1 = mel_off[m + 1];
    float acc = 0.0f;
#pragma unroll 8
    for (int j = j0; j < j1; ++j)  // one FMA chain; the loads run ahead of it
      acc = fmaf(MB ? round_bf16f(mg[j]) : mg[j], MB ? round_bf16f(__ldg(mel_w + j)) : __ldg(mel_w + j),
                 acc);
    mel_out[(row0 + r) * M + m] = db_fast(acc, nc, inv_range);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

// One launch of the bf16 kernel. bases: (2 * windows * 144, kp) bf16, the
// cos rows then the sin rows (ops/stft.py::wgmma_bases); plan: the host
// ints of ops/stft.py::bf16_plan; mel_bf16 picks MB.
static cudaError_t launch_bf16(const float* wav, const void* bases, const int* plan,
                               const int* mel_lo, const int* mel_off, const float* mel_w,
                               float* mel_out, float* lin_out, float* mag_scratch, int B, int L,
                               int T, int hop, int n0, int n_live, int NF, int M, NormConsts nc,
                               int normalize_linear, bool mel_bf16, cudaStream_t stream) {
  Bf16Plan p;
  memcpy(&p, plan, sizeof(p));
  if (p.cw < 1 || p.cw > BW_MAX_CW || (p.cw & (p.cw - 1)) || p.windows < 1 ||
      p.windows * BW_WN < NF || p.stages < 2 || p.kp % BW_KB || p.kp < n_live ||
      (p.span && hop % 2) || (!p.span && (p.kch % BW_KB || p.stride != p.kch + 8)) ||
      (p.scratch ? mag_scratch == nullptr : p.windows > p.cw) || p.a_bytes % 16 ||
      (!p.scratch && (BW_TM * BW_MS + BW_TM * M) * 4 > p.stages * BW_STAGE) ||
      p.mel_nt < 0 || p.mel_nt > 16 || (p.mel_nt > 0 && 8 * p.mel_nt < M))
    return cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)p.kp, (cuuint64_t)2 * p.windows * BW_WN};
  const cuuint64_t strides[1] = {(cuuint64_t)p.kp * 2};
  const cuuint32_t box[2] = {BW_KB, BW_WN};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(bases), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = mel_bf16 ? (p.span ? stft_bf16_wgmma_kernel<true, true>
                                   : stft_bf16_wgmma_kernel<true, false>)
                         : (p.span ? stft_bf16_wgmma_kernel<false, true>
                                   : stft_bf16_wgmma_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + BW_TM - 1) / BW_TM * p.cw, B, 1);
  cfg.blockDim = dim3(BW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cw;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const uint2* melb = reinterpret_cast<const uint2*>(bases) + p.mel_frag;
  err = cudaLaunchKernelEx(&cfg, kernel, map, melb, wav, mel_lo, mel_off, mel_w, mel_out, lin_out,
                           mag_scratch, L, T, hop, n0, n_live, NF, M, nc, normalize_linear, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
