// Device code shared by the three mel-STFT kernels (K3 stft_features.cu,
// K3' stft_fused.cu, K3'' stft_frames.cu): the dB epilogue, the
// window-baked DFT tile over the live window taps, and the fixed-order sum
// of per-tile partial mels.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

#define STFT_TF 16      // frames a block
#define STFT_FT 128     // frequency bins a tile
#define STFT_KC 32      // taps a basis slice
#define STFT_THREADS 256

struct NormConsts {
  float ref_db, min_db, max_abs;
  int symmetric;
};

// 20*log10(max(x, 1e-5)) - ref_db, then (db - min_db) / -min_db clipped to
// [0, 1] (or the symmetric [-max_abs, max_abs] map).
__device__ __forceinline__ float db_normalize(float x, NormConsts c) {
  float db = 20.0f * log10f(fmaxf(x, 1e-5f)) - c.ref_db;
  float unit = (db - c.min_db) / (-c.min_db);
  if (c.symmetric)
    return fminf(fmaxf(2.0f * c.max_abs * unit - c.max_abs, -c.max_abs), c.max_abs);
  return fminf(fmaxf(unit, 0.0f), 1.0f);
}

// Round to the nearest bfloat16 (ties to even) and back: the operand
// rounding of the bf16-bases mode; products of two such values are exact in
// float32, so only the sums round.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One tile of STFT_TF frames x STFT_FT bins starting at bin f0, computed by
// all STFT_THREADS threads of the block: the products of the frames' live
// taps with the window-baked cos/sin bases (n_live x NFp, streamed through
// the shared slices bc and bs, STFT_KC x STFT_FT each), the magnitude into
// mag[lt * mag_stride + f] in shared memory, and the linear tile (normalized
// dB, or the raw magnitude) into lin_rows[t * NF + f0 + f] for frames
// t = t0 + lt < T and bins f0 + f < NF. Tap k of frame lt is
// A[lt * a_stride + k] in shared memory. Each thread holds 4 frames x 2 bins
// of the real and imaginary sums, each one float32 FMA chain over the live
// taps (a two-level sum, partials per STFT_KC-tap slice, took 80 registers
// for 64 and K3 43% longer on an H100, and came no closer to the float64
// oracle). Starts with a barrier, so the caller may write A just before; the
// caller must sync before reading mag.
__device__ __forceinline__ void stft_tile(
    const float* A, int a_stride, const float* __restrict__ cosb,
    const float* __restrict__ sinb, int n_live, int NFp, int f0, bool bf16,
    float* bc, float* bs, float* mag, int mag_stride,
    float* __restrict__ lin_rows, int T, int t0, int NF, NormConsts nc,
    bool normalize_linear) {
  const int tid = threadIdx.x;
  const int ty = tid / 64;   // frames 4*ty .. 4*ty+3
  const int tx = tid % 64;   // bins tx and tx + 64 of the tile
  float re[4][2], im[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    re[i][0] = re[i][1] = 0.0f;
    im[i][0] = im[i][1] = 0.0f;
  }
  for (int k0 = 0; k0 < n_live; k0 += STFT_KC) {
    __syncthreads();
    for (int e = tid; e < STFT_KC * STFT_FT; e += STFT_THREADS) {
      int kk = e / STFT_FT, ff = e % STFT_FT;
      int k = k0 + kk;
      size_t g = (size_t)k * NFp + f0 + ff;
      float c = k < n_live ? cosb[g] : 0.0f;
      float s = k < n_live ? sinb[g] : 0.0f;
      if (bf16) {
        c = round_bf16(c);
        s = round_bf16(s);
      }
      bc[e] = c;
      bs[e] = s;
    }
    __syncthreads();
    const int kmax = min(STFT_KC, n_live - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float c0 = bc[kk * STFT_FT + tx], c1 = bc[kk * STFT_FT + tx + 64];
      float s0 = bs[kk * STFT_FT + tx], s1 = bs[kk * STFT_FT + tx + 64];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = A[(4 * ty + i) * a_stride + k0 + kk];
        re[i][0] = fmaf(a, c0, re[i][0]);
        re[i][1] = fmaf(a, c1, re[i][1]);
        im[i][0] = fmaf(a, s0, im[i][0]);
        im[i][1] = fmaf(a, s1, im[i][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lt = 4 * ty + i;
    const int t = t0 + lt;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = tx + 64 * j;
      float m = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      mag[lt * mag_stride + f] = m;
      if (t < T && f0 + f < NF)
        lin_rows[(size_t)t * NF + f0 + f] = normalize_linear ? db_normalize(m, nc) : m;
    }
  }
}

// The partial mel of one STFT_TF x STFT_FT magnitude tile (mag, row stride
// STFT_FT, in shared memory; padded bins hold zero and meet zero rows of
// melT): part_rows[t * M + m] = sum_f mag[lt][f] * melT[f0 + f][m] for
// frames t = t0 + lt < T. The caller syncs after writing mag.
__device__ __forceinline__ void stft_partial_mel(
    const float* mag, const float* __restrict__ melT, int f0, int M,
    float* __restrict__ part_rows, int T, int t0) {
  for (int e = threadIdx.x; e < STFT_TF * M; e += STFT_THREADS) {
    const int lt = e / M, m = e % M;
    const int t = t0 + lt;
    if (t >= T) continue;
    const float* mg = mag + lt * STFT_FT;
    const float* mt = melT + (size_t)f0 * M + m;
    float acc = 0.0f;
    for (int f = 0; f < STFT_FT; ++f) acc = fmaf(mg[f], mt[(size_t)f * M], acc);
    part_rows[(size_t)t * M + m] = acc;
  }
}

// mel[i] = db_normalize(sum_j partial[j * n + i]) over the tiles j in order
// 0, 1, ...: a fixed order, so the result does not change from run to run.
__global__ void __launch_bounds__(256)
stft_mel_reduce_kernel(const float* __restrict__ partial, float* __restrict__ mel,
                       int tiles, long long n, NormConsts nc) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int j = 0; j < tiles; ++j) acc += partial[(size_t)j * n + i];
  mel[i] = db_normalize(acc, nc);
}

// Launch the reduce over n = rows * M values on `stream`.
__host__ inline cudaError_t stft_mel_reduce(const float* partial, float* mel, int tiles,
                                            long long n, NormConsts nc,
                                            cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  stft_mel_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, mel, tiles, n, nc);
  return cudaGetLastError();
}
