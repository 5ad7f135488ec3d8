// The tensor-core mel-STFT of a wav on bf16 operands, the kernel of K3′'s
// bf16_bases mode (stft_fused.cu) and of K3's bf16 mode (stft_features.cu):
// the frames and the window-baked cos/sin bases rounded to bfloat16, their
// products summed in float32 on mma.sync (the TPU kernels' MXU form; no FFT
// computes this function), the magnitude in float32. The mel sums each
// filter's nonzero bins in float32: of the float32 magnitudes (K3′
// bf16_bases, MB = false), or of the magnitudes and the filter weights
// rounded to bfloat16 (K3's bf16 mode, MB = true: the resident Pallas
// kernel's bf16 mel product). stft_fused.cu describes the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "stft_wav.cuh"

namespace cg = cooperative_groups;

#define BF_TF 16              // frames a tile: one m16 row tile
#define BF_KA 1024            // taps of the frame tile resident in shared memory at once
#define BF_KAS (BF_KA + 8)    // its row stride in bf16: 16-byte rows, ldmatrix conflict-free
#define BF_WIN 128            // bins a window: 8 warps x 16
#define BF_MS (BF_WIN + 8)    // a window's magnitude row stride in floats
#define BF_RING 4             // k16 steps of B fragments in flight a warp
#define BF_SLOT 128           // uint2 a ring slot: 2 n8 tiles x (cos, sin) x 32 lanes
#define BF_MAX_CW 8           // the most CTAs a tile's cluster (a portable cluster)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a * b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// C 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 16 bytes global -> shared, cached in L2 only (the streamed B fragments
// would otherwise evict the mel tables from L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a bf16 CTA (`windows` bin windows in all, clusters of
// cw CTAs): the warps' rings, the tile's resident taps, the magnitudes of
// its 1/cw of the windows, and the full magnitude rows of the BF_TF / cw
// frames whose mel it sums. ops/stft.py::bf16_smem mirrors it.
__host__ __device__ constexpr size_t bf16_smem(int windows, int cw) {
  return sizeof(uint2) * (STFT_THREADS / 32) * BF_RING * BF_SLOT +
         sizeof(__nv_bfloat16) * BF_TF * BF_KAS +
         sizeof(float) * ((windows + cw - 1) / cw) * BF_TF * BF_MS +
         sizeof(float) * ((BF_TF + cw - 1) / cw) * windows * BF_WIN;
}

// Grid (tiles * cw, B) in clusters of (cw, 1, 1): the cluster owns
// BF_TF frames of utterance blockIdx.y, and CTA `rank` of it the bin windows
// [rank * wpc, (rank + 1) * wpc) of them and the mel of frames
// [rank * fpr, (rank + 1) * fpr). MB: the mel product on bf16 operands.
template <bool MB>
__global__ void __launch_bounds__(STFT_THREADS)
stft_fused_bf16_kernel(const float* __restrict__ wav,    // (B, L)
                       const uint2* __restrict__ bcos,   // mma_b_fragments(cos)
                       const uint2* __restrict__ bsin,   // mma_b_fragments(sin)
                       const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                       const float* __restrict__ mel_w,
                       float* __restrict__ mel_out,      // (B, T, M)
                       float* __restrict__ lin_out,      // (B, T, NF)
                       int L, int T, int hop, int n0, int n_live, int NF, int M,
                       NormConsts nc, int normalize_linear) {
  constexpr int TF = BF_TF;
  constexpr int KSA = BF_KA / 16;  // k16 steps a resident chunk of taps
  cg::cluster_group cluster = cg::this_cluster();
  // cw read from the cluster (a constant folded in its place ran 7% slower
  // on the H100, with the same bits)
  const int cw = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int windows = (NF + BF_WIN - 1) / BF_WIN;
  const int wpc = (windows + cw - 1) / cw, fpr = (TF + cw - 1) / cw;
  const int wbeg = min(windows, rank * wpc), wend = min(windows, wbeg + wpc);
  const int nrow = windows * BF_WIN;  // a full magnitude row

  extern __shared__ float4 smem4[];
  uint2* rings = reinterpret_cast<uint2*>(smem4);  // 8 warps x BF_RING x BF_SLOT
  __nv_bfloat16* As =
      reinterpret_cast<__nv_bfloat16*>(rings + (STFT_THREADS / 32) * BF_RING * BF_SLOT);
  float* mags = reinterpret_cast<float*>(As + TF * BF_KAS);  // wpc x TF x BF_MS
  float* full = mags + wpc * TF * BF_MS;                      // fpr x nrow

  const int b = blockIdx.y, t0 = (blockIdx.x / cw) * TF;
  const int frames = min(TF, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KS = (n_live + 15) / 16;  // k16 steps
  const int achunks = (KS + KSA - 1) / KSA;
  const float* w = wav + (size_t)b * L + (size_t)t0 * hop + n0;
  const size_t row0 = (size_t)b * T + t0;
  uint2* ring = rings + warp * BF_RING * BF_SLOT;

  // chunk ac of the tile's taps, rounded to bf16 (zero past the live taps and
  // the real frames); frame t < T lies inside the wav, so no bound on L
  // (16 loads in flight a thread: one at a time, their latency would add up)
  auto load_a = [&](int ac) {
    constexpr int PER = TF * BF_KA / STFT_THREADS;
    for (int i0 = 0; i0 < PER; i0 += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = threadIdx.x + (i0 + i) * STFT_THREADS;
        const int r = e / BF_KA, kt = ac * BF_KA + e % BF_KA;
        v[i] = r < frames && kt < n_live ? __ldg(w + (size_t)r * hop + kt) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = threadIdx.x + (i0 + i) * STFT_THREADS;
        As[(e / BF_KA) * BF_KAS + e % BF_KA] = __float2bfloat16_rn(v[i]);
      }
    }
  };
  // The warp walks its (window, k16 step) pairs in order, window-major. Its
  // B fragments for a pair, its two n8 tiles of cos and sin, go to ring slot
  // (pair % BF_RING), 16 bytes a lane twice: fragment run f = nt*2 + cs
  // (256 bytes, table[(nt * KS + k) * 32 + lane]) at slot[f * 32 + lane].
  int iw = wbeg, ik = 0;  // the next pair to fetch
  auto issue = [&](int slot) {
    if (iw < wend) {
      uint2* dst = ring + slot * BF_SLOT;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = lane + 32 * j;  // 16-byte piece of the slot
        const int f = p >> 4, off = p & 15;
        const uint2* table = (f & 1) ? bsin : bcos;
        const size_t nt = (size_t)iw * 16 + 2 * warp + (f >> 1);
        cp_async16(dst + f * 32 + 2 * off, table + (nt * KS + ik) * 32 + 2 * off);
      }
      if (++ik == KS) {
        ik = 0;
        ++iw;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll 1
  for (int s = 0; s < BF_RING; ++s) issue(s);
  if (achunks == 1) load_a(0);
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;
  int slot = 0;
  for (int win = wbeg; win < wend; ++win) {
    float acc[2][2][4];  // [n8 tile][cos, sin][fragment]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int cs = 0; cs < 2; ++cs)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][cs][i] = 0.0f;
    for (int k = 0; k < KS; ++k) {
      const int kr = k % KSA;
      if (achunks > 1 && kr == 0) {
        __syncthreads();  // every warp is done with the previous chunk
        load_a(k / KSA);
        __syncthreads();
      }
      cp_async_wait<BF_RING - 1>();  // this lane's pieces of the pair arrived
      __syncwarp();                  // ... and every lane's
      const uint2* sl = ring + slot * BF_SLOT;
      uint2 q[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int cs = 0; cs < 2; ++cs) q[nt][cs] = sl[(nt * 2 + cs) * 32 + lane];
      uint32_t a[4];
      ldmatrix_x4(a, As + (lane & 15) * BF_KAS + kr * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int cs = 0; cs < 2; ++cs) mma_bf16(acc[nt][cs], a, q[nt][cs]);
      __syncwarp();  // every lane has read the slot before it is refilled
      issue(slot);
      slot = slot + 1 == BF_RING ? 0 : slot + 1;
    }
    // magnitudes: fragment i of n8 tile nt is row g + 8*(i/2), bin
    // warp*16 + nt*8 + 2*tq + i%2 of the window
    float* mw = mags + (win - wbeg) * TF * BF_MS;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* re = acc[nt][0];
        const float* im = acc[nt][1];
        const float2 m2 = make_float2(
            sqrtf(re[2 * h] * re[2 * h] + im[2 * h] * im[2 * h]),
            sqrtf(re[2 * h + 1] * re[2 * h + 1] + im[2 * h + 1] * im[2 * h + 1]));
        *reinterpret_cast<float2*>(mw + (g + 8 * h) * BF_MS + warp * 16 + nt * 8 + 2 * tq) = m2;
      }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the linear rows of this CTA's windows, 128 consecutive bins a run
  for (int e = threadIdx.x; e < (wend - wbeg) * TF * BF_WIN; e += STFT_THREADS) {
    const int wl = e / (TF * BF_WIN), r = (e / BF_WIN) % TF, k = e % BF_WIN;
    const int bin = (wbeg + wl) * BF_WIN + k;
    if (r < frames && bin < NF) {
      const float m = mags[(wl * TF + r) * BF_MS + k];
      lin_out[(row0 + r) * NF + bin] = normalize_linear ? db_normalize(m, nc) : m;
    }
  }
  cluster.sync();  // every CTA's magnitudes are complete
  // gather the full magnitude rows of this CTA's mel frames from the CTAs
  // that own each window (distributed shared memory)
  for (int e0 = threadIdx.x; e0 < fpr * nrow; e0 += 8 * STFT_THREADS) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 8 remote loads in flight a thread
      const int e = e0 + i * STFT_THREADS;
      const int rl = e / nrow, bin = e % nrow, r = rank * fpr + rl;
      const int wi = bin / BF_WIN, owner = wi / wpc;
      v[i] = 0.0f;
      if (e < fpr * nrow && r < TF)
        v[i] = cluster.map_shared_rank(mags, owner)[((wi - owner * wpc) * TF + r) * BF_MS +
                                                    bin % BF_WIN];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (e0 + i * STFT_THREADS < fpr * nrow)
        full[e0 + i * STFT_THREADS] = MB ? __bfloat162float(__float2bfloat16_rn(v[i])) : v[i];
  }
  cluster.sync();  // the peers are done reading this CTA's magnitudes
  // each filter's nonzero bins in ascending order (K3's loop)
  for (int e = threadIdx.x; e < fpr * M; e += STFT_THREADS) {
    const int rl = e / M, m = e - rl * M, r = rank * fpr + rl;
    if (r >= frames) continue;
    const float* mg = full + (size_t)rl * nrow + mel_lo[m];
    const int j0 = mel_off[m], j1 = mel_off[m + 1];
    float acc = 0.0f;
    for (int j = j0; j < j1; ++j)
      acc = fmaf(mg[j - j0], MB ? __bfloat162float(__float2bfloat16_rn(mel_w[j])) : mel_w[j],
                 acc);
    mel_out[(row0 + r) * M + m] = db_normalize(acc, nc);
  }
}

// One launch of the bf16 kernel on clusters of cw CTAs; mel_bf16 picks MB.
static cudaError_t launch_bf16(const float* wav, const int* bcos, const int* bsin,
                               const int* mel_lo, const int* mel_off, const float* mel_w,
                               float* mel_out, float* lin_out, int B, int L, int T, int hop,
                               int n0, int n_live, int NF, int M, int cw, NormConsts nc,
                               int normalize_linear, bool mel_bf16, cudaStream_t stream) {
  if (cw < 1 || cw > BF_MAX_CW) return cudaErrorInvalidValue;
  const size_t smem = bf16_smem((NF + BF_WIN - 1) / BF_WIN, cw);
  auto kernel = mel_bf16 ? stft_fused_bf16_kernel<true> : stft_fused_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + BF_TF - 1) / BF_TF * cw, B, 1);
  cfg.blockDim = dim3(STFT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cw;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, wav,
                           reinterpret_cast<const uint2*>(bcos),
                           reinterpret_cast<const uint2*>(bsin), mel_lo, mel_off, mel_w, mel_out,
                           lin_out, L, T, hop, n0, n_live, NF, M, nc, normalize_linear);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

