// K3'' — mel-STFT features of pre-framed raw frames: (F, n_fft) un-windowed
// frames in device memory -> mel (F, M) normalized dB and linear (F, NF)
// normalized dB or (normalize_linear = 0) the magnitude.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas
//           (kernel _stft_kernel; PallasDSP's kernel).
//
// Only the window's live taps [n0, n0 + n_live) of each frame are read: the
// padded window is zero outside them. Any F (the kernel masks the ragged
// last block) and any n_fft: a frame whose transform does not fit one
// block's shared memory (ops/stft.py::fft_frames_per_block gives 0) runs the
// same stages on two buffers of a device-memory scratch, one frame a block
// at a time (block x walks frames x, x + gridDim.x, ...).
//
// Bound on the H100 at the main-path shape (1024 frames a launch, the frames
// of 8 wavs of 128 frames; n_fft 2048, n_live 1024, 1025 bins, 80 mels): a
// real FFT is about 2.5 * 2048 * 11 = 56 kFLOP a frame, 0.06 GFLOP a launch,
// against 4.2 MB of live frame columns read and 4.5 MB of outputs written:
// the bytes bound it (about 2.6 us at 3.35 TB/s). The frames matrix itself
// is the intermediate that K3 and K3' avoid: its writer (the framing
// outside this kernel) moves n_fft / hop times the wav's bytes.
//
// Design: K3's (stft_wav.cuh) on pre-framed input, one launch. A
// block of 256 threads owns `fr` consecutive frames (4, 2 or 1: the most
// whose buffers fit and whose grid still gives every SM two blocks, so the
// KernelDSP calls of 100-1200 frames spread over the card). It loads the
// frames' live columns once, coalesced (16 bytes a lane when the rows allow
// it), into the FFT's second buffer; the first FFT stage forms its inputs
// from them and the window (stft.cuh::stft_fft_block). The split step, the
// magnitudes in the free buffer, the linear rows out coalesced, and the mel
// over each filter's nonzero bins in ascending order follow. No atomics:
// the same bits every run, and K3's bits.

#include "stft.cuh"

__global__ void __launch_bounds__(STFT_THREADS)
stft_frames_kernel(const float* __restrict__ raw,      // (F, n_fft)
                   const float2* __restrict__ table,   // fft_plan's table
                   const float* __restrict__ window,   // (n_live,) live taps
                   const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                   const float* __restrict__ mel_w,
                   float* __restrict__ mel_out,        // (F, M)
                   float* __restrict__ lin_out,        // (F, NF)
                   int F, int n_fft, int n0, int n_live, int M, int fr, FftPlan plan,
                   NormConsts nc, int normalize_linear, int vec4,
                   float2* scratch) {                  // (gridDim.x, 2, n) when fr = 0
  const int NF = n_fft / 2 + 1;
  if (fr == 0) {
    float2* bufa = scratch + (size_t)blockIdx.x * 2 * plan.n;
    float2* bufb = bufa + plan.n;
    for (int t = blockIdx.x; t < F; t += gridDim.x) {
      const float* x = raw + (size_t)t * n_fft + n0;
      auto tap = [x, window, n_live](int f, int j) {
        return j < n_live ? __ldg(x + j) * __ldg(window + j) : 0.0f;
      };
      stft_fft_block(tap, bufa, bufb, n_fft, plan, 1, 1, table, mel_lo, mel_off, mel_w, M,
                     mel_out + (size_t)t * M, lin_out + (size_t)t * NF, nc, normalize_linear);
      __syncthreads();  // the next frame reuses the buffers
    }
    return;
  }
  extern __shared__ float4 smem4[];
  float2* bufa = reinterpret_cast<float2*>(smem4);  // fr * n
  float2* bufb = bufa + fr * plan.n;                // fr * n; first the live taps
  float* A = reinterpret_cast<float*>(bufb);        // fr * n_live

  const int t0 = blockIdx.x * fr;
  const int frames = min(fr, F - t0);
  const float* rows = raw + (size_t)t0 * n_fft + n0;
  if (vec4) {
    const int q = n_live >> 2;
    for (int e = threadIdx.x; e < fr * q; e += STFT_THREADS) {
      const int f = e / q, c = e - f * q;
      reinterpret_cast<float4*>(A)[e] =
          f < frames ? __ldg(reinterpret_cast<const float4*>(rows + (size_t)f * n_fft) + c)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < fr * n_live; e += STFT_THREADS) {
      const int f = e / n_live, j = e - f * n_live;
      A[e] = f < frames ? __ldg(rows + (size_t)f * n_fft + j) : 0.0f;
    }
  }
  __syncthreads();

  auto tap = [A, window, n_live](int f, int j) {
    return j < n_live ? A[f * n_live + j] * __ldg(window + j) : 0.0f;
  };
  stft_fft_block(tap, bufa, bufb, n_fft, plan, fr, frames, table, mel_lo, mel_off, mel_w, M,
                 mel_out + (size_t)t0 * M, lin_out + (size_t)t0 * NF, nc, normalize_linear);
}

extern "C" int stft_frames_launch(const float* frames, const float* table,
                                  const float* window, const int* mel_lo, const int* mel_off,
                                  const float* mel_w, float* mel_out, float* lin_out, int F,
                                  int n_fft, int n0, int n_live, int M, int fr, int slots,
                                  const int* radix, int stages, float ref_db, float min_db,
                                  float max_abs, int symmetric, int normalize_linear,
                                  float* scratch, cudaStream_t stream) {
  FftPlan plan;
  const int n = n_fft % 2 == 0 ? n_fft / 2 : n_fft;
  if (F < 1 || fr < 0 || n0 < 0 || n_live < 1 || n0 + n_live > n_fft ||
      (fr == 0 && (slots < 1 || scratch == nullptr)) || !make_fft_plan(&plan, n, radix, stages))
    return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  const size_t smem = 2 * sizeof(float2) * (size_t)fr * n;
  cudaError_t err = cudaFuncSetAttribute(
      stft_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // float4 rows: 16-byte aligned in device memory and in shared memory
  const int vec4 = ((uintptr_t)frames % 16 == 0) && n_fft % 4 == 0 && n0 % 4 == 0 &&
                   n_live % 4 == 0 && ((size_t)fr * n) % 2 == 0;
  stft_frames_kernel<<<fr ? (F + fr - 1) / fr : slots, STFT_THREADS, smem, stream>>>(
      frames, reinterpret_cast<const float2*>(table), window, mel_lo, mel_off, mel_w, mel_out,
      lin_out, F, n_fft, n0, n_live, M, fr, plan, nc, normalize_linear, vec4,
      reinterpret_cast<float2*>(scratch));
  return (int)cudaGetLastError();
}
