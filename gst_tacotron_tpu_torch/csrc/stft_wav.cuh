// The float32 mel-STFT of a wav: one kernel for K3 (stft_features.cu) and
// K3' float32 (stft_fused.cu), which compute the same function; each source
// has its own launcher and launch counter.
//
// Input: (B, L) float32 wav, preemphasized, reflect-padded at the centre per
// utterance and zero-padded to the bucket length; frame t covers samples
// [t*hop, t*hop + n_fft), of which only the window's live taps
// [n0, n0 + n_live) are nonzero after windowing. Output: mel (B, T, M)
// normalized dB, linear (B, T, NF) normalized dB or (normalize_linear = 0)
// the magnitude.
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch;
// n_fft 2048, n_live 1024, 1025 bins, 80 mels): a real FFT, about 56 kFLOP a
// frame, against 1.1 MB of wav read and 4.5 MB of outputs written: the bytes
// bound it (about 1.7 us at 3.35 TB/s).
//
// Design: a block of 256 threads owns `fr` consecutive frames of one
// utterance (ops/stft.py::fft_frames_per_block), loads their
// (fr-1)*hop + n_live samples once into the FFT's second buffer (framing in
// shared memory), and runs stft.cuh::stft_fft_block: the mixed-radix FFT of
// each windowed frame, split step, magnitudes, linear rows, sparse mel. One
// launch, no atomics, the same bits every run. A frame whose transform does
// not fit one block's shared memory (fr = 0) runs the same stages on two
// buffers of a device-memory scratch, one frame a block at a time: the
// block (x, y) walks frames x, x + gridDim.x, ... of utterance y.
#pragma once

#include "stft.cuh"

__global__ void __launch_bounds__(STFT_THREADS)
stft_wav_kernel(const float* __restrict__ wav,      // (B, L)
                const float2* __restrict__ table,   // fft_plan's table
                const float* __restrict__ window,   // (n_live,) live taps
                const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                const float* __restrict__ mel_w,
                float* __restrict__ mel_out,        // (B, T, M)
                float* __restrict__ lin_out,        // (B, T, NF)
                int L, int T, int hop, int n0, int n_live, int n_fft, int M, int fr,
                FftPlan plan, NormConsts nc, int normalize_linear,
                float2* scratch) {                  // (B, gridDim.x, 2, n) when fr = 0
  const int b = blockIdx.y;
  const int NF = n_fft / 2 + 1;
  const float* w = wav + (size_t)b * L;
  if (fr == 0) {
    float2* bufa = scratch + ((size_t)b * gridDim.x + blockIdx.x) * 2 * plan.n;
    float2* bufb = bufa + plan.n;
    for (int t = blockIdx.x; t < T; t += gridDim.x) {
      const float* x = w + (size_t)t * hop + n0;    // frame t < T lies inside the wav
      auto tap = [x, window, n_live](int f, int j) {
        return j < n_live ? x[j] * __ldg(window + j) : 0.0f;
      };
      const size_t row = (size_t)b * T + t;
      stft_fft_block(tap, bufa, bufb, n_fft, plan, 1, 1, table, mel_lo, mel_off, mel_w, M,
                     mel_out + row * M, lin_out + row * NF, nc, normalize_linear);
      __syncthreads();  // the next frame reuses the buffers
    }
    return;
  }
  extern __shared__ float4 smem4[];
  float2* bufa = reinterpret_cast<float2*>(smem4);  // fr * n
  float2* bufb = bufa + fr * plan.n;                // fr * n; first the samples
  float* seg = reinterpret_cast<float*>(bufb);      // (fr - 1) * hop + n_live

  const int t0 = blockIdx.x * fr;
  const int frames = min(fr, T - t0);
  const int seg_len = (fr - 1) * hop + n_live;
  const int base = t0 * hop + n0;
  for (int i = threadIdx.x; i < seg_len; i += STFT_THREADS) {
    const int s = base + i;
    seg[i] = s < L ? w[s] : 0.0f;
  }
  __syncthreads();

  auto tap = [seg, window, hop, n_live](int f, int j) {
    return j < n_live ? seg[f * hop + j] * __ldg(window + j) : 0.0f;
  };
  const size_t row0 = (size_t)b * T + t0;
  stft_fft_block(tap, bufa, bufb, n_fft, plan, fr, frames, table, mel_lo, mel_off, mel_w, M,
                 mel_out + row0 * M, lin_out + row0 * NF, nc, normalize_linear);
}

// Launch stft_wav_kernel: `fr` frames a block in shared memory, or fr = 0
// and `slots` blocks an utterance on `scratch` (B * slots * 2 * n float2).
static cudaError_t launch_stft_wav(const float* wav, const float* table, const float* window,
                                   const int* mel_lo, const int* mel_off, const float* mel_w,
                                   float* mel_out, float* lin_out, int B, int L, int T, int hop,
                                   int n0, int n_live, int n_fft, int M, int fr, int slots,
                                   const int* radix, int stages, NormConsts nc,
                                   int normalize_linear, float* scratch,
                                   cudaStream_t stream) {
  FftPlan plan;
  const int n = n_fft % 2 == 0 ? n_fft / 2 : n_fft;
  if (B < 1 || T < 1 || B > 65535 || n0 < 0 || n_live < 1 || n0 + n_live > n_fft || fr < 0 ||
      (fr == 0 && (slots < 1 || scratch == nullptr)) || !make_fft_plan(&plan, n, radix, stages))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float2) * (size_t)fr * n;
  cudaError_t err = cudaFuncSetAttribute(
      stft_wav_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(fr ? (T + fr - 1) / fr : slots, B);
  stft_wav_kernel<<<grid, STFT_THREADS, smem, stream>>>(
      wav, reinterpret_cast<const float2*>(table), window, mel_lo, mel_off, mel_w, mel_out,
      lin_out, L, T, hop, n0, n_live, n_fft, M, fr, plan, nc, normalize_linear,
      reinterpret_cast<float2*>(scratch));
  return cudaGetLastError();
}
