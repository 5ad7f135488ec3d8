// K3 — mel-STFT features in one launch: the windowed live taps of each
// frame through a shared-memory real FFT, the magnitude, the normalized-dB
// linear spectrogram (or the raw magnitude, normalize_linear = 0), then the
// mel over each filter's nonzero bins and its normalized-dB epilogue.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas_resident
//           (kernel _stft_resident_kernel).
//
// Input: (B, L) float32 wav, already preemphasized, reflect-padded at the
// centre per utterance and zero-padded to the bucket length. Frame t covers
// samples [t*hop, t*hop + n_fft); the padded Hann window is zero outside its
// live taps [n0, n0 + n_live). n_fft is a power of two (the wrapper raises
// otherwise and names the "fused" route, K3', which takes any hop | n_fft).
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch,
// 4 launches per synthesis; n_fft 2048, 1025 bins, 80 mels): the real FFT is
// about 2.5 * 2048 * 11 = 56 kFLOP a frame and the mel's nonzero terms a few
// thousand more, ~0.25 GFLOP per synthesis, against 4.4 MB of wav read and
// 18 MB of linear and mel written: the bytes bound it (about 7 us at
// 3.35 TB/s).
//
// Design: a block of 256 threads owns FFT_FRAMES consecutive frames of one
// utterance. It loads the frames' overlapping samples once into shared
// memory ((FFT_FRAMES-1)*hop + n_live floats), with the window's live taps
// and the host-built float64-derived twiddles. Each frame's live taps are
// rotated to the start of the frame (a circular shift changes only the phase
// of each bin), packed as z[m] = x[2m] + i*x[2m+1] into an n_fft/2-point
// complex FFT (Stockham, fft.cuh), whose first stage forms z on the fly from
// the samples and the window. The split step gives the n_fft/2 + 1 bins; the
// magnitudes go to shared memory (the FFT's free ping-pong buffer) and the
// linear rows out coalesced. The mel sums each filter's nonzero bins in
// ascending order from host tables (fmaf(0, x, acc) == acc, so this is the
// dense loop's sum). No scratch, no atomics: the same bits every run.

#include "fft.cuh"
#include "stft.cuh"

#define FFT_FRAMES 4
#define FFT_THREADS 256

__global__ void __launch_bounds__(FFT_THREADS)
stft_features_kernel(const float* __restrict__ wav,       // (B, L)
                     const float2* __restrict__ twiddle,  // (n_fft,) see fft.cuh
                     const float* __restrict__ window,    // (n_live,) live taps
                     const int* __restrict__ mel_lo,      // (M,) first bin
                     const int* __restrict__ mel_off,     // (M + 1,) into mel_w
                     const float* __restrict__ mel_w,     // nonzero weights
                     float* __restrict__ mel_out,         // (B, T, M)
                     float* __restrict__ lin_out,         // (B, T, NF)
                     int L, int T, int hop, int n0, int n_live, int n_fft, int M,
                     NormConsts nc, int normalize_linear) {
  extern __shared__ float4 smem4[];
  const int h = n_fft >> 1;
  const int NF = h + 1;
  const int seg_len = (FFT_FRAMES - 1) * hop + n_live;
  float2* tw = reinterpret_cast<float2*>(smem4);   // n_fft
  float2* bufa = tw + n_fft;                        // FFT_FRAMES * h
  float2* bufb = bufa + FFT_FRAMES * h;             // FFT_FRAMES * h
  float* win = reinterpret_cast<float*>(bufb + FFT_FRAMES * h);  // n_live
  float* seg = win + n_live;                        // seg_len

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FFT_FRAMES;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_fft; i += FFT_THREADS) tw[i] = twiddle[i];
  for (int i = tid; i < n_live; i += FFT_THREADS) win[i] = window[i];
  const float* w = wav + (size_t)b * L;
  const int base = t0 * hop + n0;
  for (int i = tid; i < seg_len; i += FFT_THREADS) {
    const int s = base + i;
    seg[i] = s < L ? w[s] : 0.0f;
  }
  __syncthreads();

  // z[m] of frame f: its live taps 2m and 2m + 1, windowed; zero past n_live
  auto load = [seg, win, hop, n_live](int f, int m) {
    const int j = 2 * m;
    const float* x = seg + f * hop;
    return make_float2(j < n_live ? x[j] * win[j] : 0.0f,
                       j + 1 < n_live ? x[j + 1] * win[j + 1] : 0.0f);
  };
  const float2* Z = fft_pow2(load, bufa, bufb, h, h, FFT_FRAMES, tw);
  float* mag = reinterpret_cast<float*>(Z == bufa ? bufb : bufa);  // FFT_FRAMES * NF
  const float2* split = tw + (h - 1);

  float* lin_rows = lin_out + ((size_t)b * T + t0) * NF;
  const int frames = min(FFT_FRAMES, T - t0);
  for (int e = tid; e < FFT_FRAMES * NF; e += FFT_THREADS) {
    const int f = e / NF, k = e - f * NF;
    const float2 X = rfft_split(Z + f * h, h, k, split);
    const float m = sqrtf(X.x * X.x + X.y * X.y);
    mag[e] = m;
    if (f < frames) lin_rows[e] = normalize_linear ? db_normalize(m, nc) : m;
  }
  __syncthreads();

  for (int e = tid; e < frames * M; e += FFT_THREADS) {
    const int f = e / M, m = e - f * M;
    const float* mg = mag + f * NF + mel_lo[m];
    const int j0 = mel_off[m], j1 = mel_off[m + 1];
    float acc = 0.0f;
    for (int j = j0; j < j1; ++j) acc = fmaf(mg[j - j0], mel_w[j], acc);
    mel_out[((size_t)b * T + t0 + f) * M + m] = db_normalize(acc, nc);
  }
}

extern "C" int stft_features_launch(const float* wav, const float* twiddle,
                                    const float* window, const int* mel_lo,
                                    const int* mel_off, const float* mel_w,
                                    float* mel_out, float* lin_out, int B, int L, int T,
                                    int hop, int n0, int n_live, int n_fft, int M,
                                    float ref_db, float min_db, float max_abs,
                                    int symmetric, int normalize_linear,
                                    cudaStream_t stream) {
  if (n_fft < 8 || (n_fft & (n_fft - 1)) != 0) return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  const int seg_len = (FFT_FRAMES - 1) * hop + n_live;
  const size_t smem = sizeof(float2) * ((size_t)n_fft + (size_t)FFT_FRAMES * n_fft) +
                      sizeof(float) * ((size_t)n_live + seg_len);
  cudaError_t err = cudaFuncSetAttribute(
      stft_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FFT_FRAMES - 1) / FFT_FRAMES, B);
  stft_features_kernel<<<grid, FFT_THREADS, smem, stream>>>(
      wav, reinterpret_cast<const float2*>(twiddle), window, mel_lo, mel_off, mel_w,
      mel_out, lin_out, L, T, hop, n0, n_live, n_fft, M, nc, normalize_linear);
  return (int)cudaGetLastError();
}
