// K3'' — mel-STFT features of pre-framed raw frames: (F, n_fft) un-windowed
// frames in device memory -> mel (F, M) normalized dB and linear (F, NF)
// normalized dB or (normalize_linear = 0) the magnitude.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas
//           (kernel _stft_kernel; PallasDSP's kernel).
//
// The window is baked into the cos/sin bases, which are zero outside the
// window's live taps [n0, n0 + n_live), so only those columns of each frame
// are read and multiplied: skipping the zero rows of the bases is exact. Any
// F: the kernel masks the ragged last frame tile itself.
//
// Bound on the H100 at the main-path shape (1024 frames a launch, the
// frames of 8 wavs of 128 frames; n_live = 1024, 1025 bins, 80 mels): about
// 4.5 GFLOP a launch on the float32 pipe (67 TFLOP/s), about 67 us, against
// 4.2 MB of live frame columns read and 4.5 MB of outputs written (about
// 2.6 us at 3.35 TB/s): operations bound it. The frames matrix itself is the
// intermediate that K3 and K3' avoid: its writer (the framing outside this
// kernel) moves n_fft / hop times the wav's bytes.
//
// Design: the frequency split of K3' (stft_fused.cu): one block per
// (STFT_TF-frame tile, 128-bin tile), which loads its frames' live columns
// into shared memory (STFT_TF x n_live, 64 KB at n_live = 1024, coalesced
// along the taps), computes the tile's DFT products and magnitudes
// (stft.cuh::stft_tile), writes the linear tile and a partial mel to a
// scratch buffer (tiles, F, M); a second launch sums the partials over the
// tiles in a fixed order and applies the dB epilogue (no atomics). 576
// blocks at the main-path shape, two to an SM. Simple float32 FMAs on the
// CUDA cores; tensor cores are later work.

#include "stft.cuh"

__global__ void __launch_bounds__(STFT_THREADS)
stft_frames_kernel(const float* __restrict__ frames,  // (F, n_fft)
                   const float* __restrict__ cosb,    // (n_live, NFp)
                   const float* __restrict__ sinb,    // (n_live, NFp)
                   const float* __restrict__ melT,    // (NFp, M)
                   float* __restrict__ partial,       // (NFp / FT, F, M)
                   float* __restrict__ lin_out,       // (F, NF)
                   int F, int n_fft, int n0, int n_live, int NF, int NFp, int M,
                   NormConsts nc, int normalize_linear) {
  extern __shared__ float smem[];
  float* A = smem;                             // TF * n_live
  float* bc = A + STFT_TF * n_live;            // KC * FT
  float* bs = bc + STFT_KC * STFT_FT;          // KC * FT
  float* mag = bs + STFT_KC * STFT_FT;         // TF * FT

  const int tile = blockIdx.y;
  const int f0 = tile * STFT_FT;
  const int t0 = blockIdx.x * STFT_TF;

  for (int e = threadIdx.x; e < STFT_TF * n_live; e += STFT_THREADS) {
    const int lt = e / n_live, k = e % n_live;
    const int t = t0 + lt;
    A[e] = t < F ? frames[(size_t)t * n_fft + n0 + k] : 0.0f;
  }

  stft_tile(A, n_live, cosb, sinb, n_live, NFp, f0, false, bc, bs, mag, STFT_FT,
            lin_out, F, t0, NF, nc, normalize_linear != 0);
  __syncthreads();
  stft_partial_mel(mag, melT, f0, M, partial + (size_t)tile * F * M, F, t0);
}

extern "C" int stft_frames_launch(const float* frames, const float* cosb,
                                  const float* sinb, const float* melT,
                                  float* partial, float* mel_out, float* lin_out,
                                  int F, int n_fft, int n0, int n_live, int NF,
                                  int NFp, int M, float ref_db, float min_db,
                                  float max_abs, int symmetric, int normalize_linear,
                                  cudaStream_t stream) {
  if (NFp % STFT_FT != 0 || F < 1 || n0 < 0 || n0 + n_live > n_fft)
    return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  size_t smem = sizeof(float) * ((size_t)STFT_TF * n_live + 2 * STFT_KC * STFT_FT +
                                 (size_t)STFT_TF * STFT_FT);
  cudaError_t err = cudaFuncSetAttribute(
      stft_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = NFp / STFT_FT;
  dim3 grid((F + STFT_TF - 1) / STFT_TF, tiles);
  stft_frames_kernel<<<grid, STFT_THREADS, smem, stream>>>(
      frames, cosb, sinb, melT, partial, lin_out, F, n_fft, n0, n_live, NF, NFp, M,
      nc, normalize_linear);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stft_mel_reduce(partial, mel_out, tiles, (long long)F * M, nc, stream);
}
