// Device code shared by the three mel-STFT kernels (K3 stft_features.cu,
// K3' stft_fused.cu, K3'' stft_frames.cu): the dB epilogue, and the
// mixed-radix FFT features of a block's frames (K3', K3'').
#pragma once

#include "common.cuh"
#include "fft.cuh"

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

// Features of a block's `fr` frames (the first `frames` of them real) by
// all threads, K3's arithmetic for any n_fft: tap(f, j) is frame f's
// windowed live tap j (0 past the live taps). An even n_fft packs the frame
// as z[m] = x[2m] + i*x[2m+1] into an n_fft/2-point transform and splits it;
// an odd one transforms the n_fft real samples. The magnitudes go to the
// FFT's free buffer, the linear rows (normalized dB, or the magnitude) out
// to lin_rows (frame f at lin_rows[f * NF]), coalesced; then each mel
// filter's nonzero bins are summed in ascending order into mel_rows (frame f
// at mel_rows[f * M]). bufa and bufb hold fr * plan.n float2 each; tap may
// read bufb, which the first stage leaves before writing bufa.
template <class Tap>
__device__ __forceinline__ void stft_fft_block(
    Tap tap, float2* bufa, float2* bufb, int n_fft, const FftPlan& plan, int fr, int frames,
    const float2* __restrict__ table, const int* __restrict__ mel_lo,
    const int* __restrict__ mel_off, const float* __restrict__ mel_w, int M,
    float* __restrict__ mel_rows, float* __restrict__ lin_rows, NormConsts nc,
    int normalize_linear) {
  const int n = plan.n;
  const int NF = n_fft / 2 + 1;
  const bool packed = (n_fft & 1) == 0;
  const float2* Z;
  if (packed)
    Z = fft_mixed([tap](int f, int m) { return make_float2(tap(f, 2 * m), tap(f, 2 * m + 1)); },
                  bufa, bufb, n, plan, fr, table);
  else
    Z = fft_mixed([tap](int f, int m) { return make_float2(tap(f, m), 0.0f); }, bufa, bufb,
                  n, plan, fr, table);
  float* mag = reinterpret_cast<float*>(Z == bufa ? bufb : bufa);  // fr * NF
  const float2* split = table + fft_plan_table_head(plan);

  for (int e = threadIdx.x; e < fr * NF; e += blockDim.x) {
    const int f = e / NF, k = e - f * NF;
    const float2 X = packed ? rfft_split_mod(Z + f * n, n, k, split) : Z[f * n + k];
    const float m = sqrtf(X.x * X.x + X.y * X.y);
    mag[e] = m;
    if (f < frames) lin_rows[e] = normalize_linear ? db_normalize(m, nc) : m;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < frames * M; e += blockDim.x) {
    const int f = e / M, m = e - f * M;
    const float* mg = mag + f * NF + mel_lo[m];
    const int j0 = mel_off[m], j1 = mel_off[m + 1];
    float acc = 0.0f;
    for (int j = j0; j < j1; ++j) acc = fmaf(mg[j - j0], mel_w[j], acc);
    mel_rows[(size_t)f * M + m] = db_normalize(acc, nc);
  }
}

// The FftPlan of a launcher's host radix list, or false when it does not
// describe n.
__host__ inline bool make_fft_plan(FftPlan* plan, int n, const int* radix, int stages) {
  if (n < 1 || stages < 1 || stages > FFT_MAX_STAGES) return false;
  plan->n = n;
  plan->stages = stages;
  long long prod = 1;
  for (int s = 0; s < stages; ++s) {
    if (radix[s] < 1) return false;
    plan->radix[s] = radix[s];
    prod *= radix[s];
  }
  return prod == n;
}
