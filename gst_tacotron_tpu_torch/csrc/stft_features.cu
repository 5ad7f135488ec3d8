// K3 — mel-STFT features: hop-chunk framing of the live window taps,
// window-baked DFT cos/sin products, magnitude, normalized-dB linear
// spectrogram (or the raw magnitude, normalize_linear = 0), then the mel
// product and its normalized-dB epilogue, all in one launch. The DFT tile
// and the dB map are shared with K3' and K3'' (stft.cuh).
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas_resident
//           (kernel _stft_resident_kernel).
//
// Input: (B, L) float32 wav, already preemphasized, reflect-padded at the
// centre per utterance and zero-padded to the bucket length. Frame t covers
// samples [t*hop, t*hop + n_fft); only the window's live taps
// [n0, n0 + n_live) are multiplied (the padded Hann window is zero outside).
// dB normalization: 20*log10(max(x, 1e-5)) - ref_db, then (db - min_db) /
// -min_db clipped to [0, 1] (or the symmetric [-max_abs, max_abs] map).
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch,
// 4 launches per synthesis; n_live = 1024, 1025 bins, 80 mels): each frame
// costs 2 * 2 * n_live * 1025 FLOPs for the two DFT products plus
// 2 * 1025 * 80 for the mel product, about 17.9 GFLOP per synthesis against
// ~17 MB written, so the float32 pipe bounds it (about 0.27 ms at
// 67 TFLOP/s).
//
// Design: a block owns TF consecutive frames of one utterance and every
// frequency. It loads the frames' samples once into shared memory (frames
// overlap, so TF frames need only (TF-1)*hop + n_live samples), walks the
// frequency axis in FT-bin tiles, and for each tile streams KC-row slices of
// the cos and sin bases through shared memory into a register-tiled product
// (each thread holds 4 frames x 2 bins of both real and imaginary sums;
// stft.cuh::stft_tile). The magnitudes of all bins stay in shared memory, so
// the mel product and its epilogue run in the same block without reading the
// linear spectrogram back. Tensor-core (TF32/bf16) products are left for a
// later change.

#include "stft.cuh"

__global__ void __launch_bounds__(STFT_THREADS)
stft_features_kernel(const float* __restrict__ wav,    // (B, L)
                     const float* __restrict__ cosb,   // (n_live, NFp)
                     const float* __restrict__ sinb,   // (n_live, NFp)
                     const float* __restrict__ melT,   // (NFp, M)
                     float* __restrict__ mel_out,      // (B, T, M)
                     float* __restrict__ lin_out,      // (B, T, NF)
                     int L, int T, int hop, int n0, int n_live, int NF,
                     int NFp, int M, NormConsts nc, int normalize_linear) {
  extern __shared__ float smem[];
  const int seg_len = (STFT_TF - 1) * hop + n_live;
  float* seg = smem;                           // seg_len
  float* bc = seg + seg_len;                   // KC * FT
  float* bs = bc + STFT_KC * STFT_FT;          // KC * FT
  float* mag = bs + STFT_KC * STFT_FT;         // TF * NFp

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * STFT_TF;
  const int tid = threadIdx.x;

  const float* w = wav + (size_t)b * L;
  const int base = t0 * hop + n0;
  for (int i = tid; i < seg_len; i += STFT_THREADS) {
    int s = base + i;
    seg[i] = s < L ? w[s] : 0.0f;
  }

  for (int f0 = 0; f0 < NFp; f0 += STFT_FT)
    stft_tile(seg, hop, cosb, sinb, n_live, NFp, f0, false, bc, bs, mag + f0, NFp,
              lin_out + (size_t)b * T * NF, T, t0, NF, nc, normalize_linear != 0);
  __syncthreads();

  for (int e = tid; e < STFT_TF * M; e += STFT_THREADS) {
    const int lt = e / M, m = e % M;
    const int t = t0 + lt;
    if (t >= T) continue;
    const float* mg = mag + lt * NFp;
    float acc = 0.0f;
    for (int f = 0; f < NF; ++f) acc = fmaf(mg[f], melT[(size_t)f * M + m], acc);
    mel_out[((size_t)b * T + t) * M + m] = db_normalize(acc, nc);
  }
}

extern "C" int stft_features_launch(const float* wav, const float* cosb,
                                    const float* sinb, const float* melT,
                                    float* mel_out, float* lin_out, int B,
                                    int L, int T, int hop, int n0, int n_live,
                                    int NF, int NFp, int M, float ref_db,
                                    float min_db, float max_abs, int symmetric,
                                    int normalize_linear, cudaStream_t stream) {
  if (NFp % STFT_FT != 0) return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  const int seg_len = (STFT_TF - 1) * hop + n_live;
  size_t smem = sizeof(float) *
                ((size_t)seg_len + 2 * STFT_KC * STFT_FT + (size_t)STFT_TF * NFp);
  cudaError_t err = cudaFuncSetAttribute(
      stft_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + STFT_TF - 1) / STFT_TF, B);
  stft_features_kernel<<<grid, STFT_THREADS, smem, stream>>>(
      wav, cosb, sinb, melT, mel_out, lin_out, L, T, hop, n0, n_live, NF, NFp,
      M, nc, normalize_linear);
  return (int)cudaGetLastError();
}
