// K3' — mel-STFT features split over frequency tiles: the function of K3
// (stft_features.cu) with one block per (utterance, frame tile, 128-bin
// tile), framing in the block, and the mel summed over the tiles by a second
// launch.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas_fused
//           (kernel _stft_fused_kernel).
//
// Input: (B, L) float32 wav, preemphasized, reflect-padded at the centre per
// utterance and zero-padded to the bucket length; frame t covers samples
// [t*hop, t*hop + n_fft), of which only the window's live taps
// [n0, n0 + n_live) are multiplied. Output: mel (B, T, M) normalized dB,
// linear (B, T, NF) normalized dB or (normalize_linear = 0) the magnitude.
// bf16 = 1 rounds the frames and the cos/sin bases to bfloat16 and sums in
// float32 (the JAX kernel's bf16_bases); the mel product stays float32.
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch;
// n_live = 1024, 1025 bins, 80 mels): 2 * 2 * 1024 * 1025 + 2 * 1025 * 80
// FLOPs a frame, about 4.5 GFLOP a launch on the float32 pipe (67 TFLOP/s),
// about 67 us, against about 4.5 MB of wav read and outputs written (about
// 1.4 us at 3.35 TB/s): operations bound it. The partial mels add 2 x 2.9 MB
// of scratch traffic a launch, about 2 us.
//
// Design: on the TPU the mel sum over frequency tiles rides a sequential
// grid axis in VMEM. Blocks on the card carry nothing between them, so each
// block owns STFT_TF frames of one utterance and one STFT_FT-bin tile: it
// loads the frames' (STFT_TF - 1) * hop + n_live samples once into shared
// memory (frames overlap by n_fft - hop, so this is framing from hop chunks,
// live taps only), computes the tile's DFT products and magnitudes
// (stft.cuh::stft_tile), writes its linear tile, and writes the partial mel
// of its bins (STFT_TF x M) to a scratch buffer (tiles, B*T, M). A second,
// small launch sums the partials over the tiles in a fixed order and applies
// the dB epilogue: no atomics, so the result is deterministic. The split
// gives the card B * ceil(T/16) * ceil(NF/128) blocks (576 at the main-path
// shape, against K3's 64) of about 59 KB of shared memory each, three to an
// SM. Simple float32 FMAs on the CUDA cores; tensor cores are later work.

#include "stft.cuh"

__global__ void __launch_bounds__(STFT_THREADS)
stft_fused_kernel(const float* __restrict__ wav,     // (B, L)
                  const float* __restrict__ cosb,    // (n_live, NFp)
                  const float* __restrict__ sinb,    // (n_live, NFp)
                  const float* __restrict__ melT,    // (NFp, M)
                  float* __restrict__ partial,       // (NFp / FT, B * T, M)
                  float* __restrict__ lin_out,       // (B, T, NF)
                  int L, int T, int hop, int n0, int n_live, int NF, int NFp,
                  int M, NormConsts nc, int normalize_linear, int bf16) {
  extern __shared__ float smem[];
  const int seg_len = (STFT_TF - 1) * hop + n_live;
  float* seg = smem;                           // seg_len
  float* bc = seg + seg_len;                   // KC * FT
  float* bs = bc + STFT_KC * STFT_FT;          // KC * FT
  float* mag = bs + STFT_KC * STFT_FT;         // TF * FT

  const int b = blockIdx.z;
  const int tile = blockIdx.y;
  const int f0 = tile * STFT_FT;
  const int t0 = blockIdx.x * STFT_TF;

  const float* w = wav + (size_t)b * L;
  const int base = t0 * hop + n0;
  for (int i = threadIdx.x; i < seg_len; i += STFT_THREADS) {
    int s = base + i;
    float x = s < L ? w[s] : 0.0f;
    seg[i] = bf16 ? round_bf16(x) : x;
  }

  stft_tile(seg, hop, cosb, sinb, n_live, NFp, f0, bf16 != 0, bc, bs, mag, STFT_FT,
            lin_out + (size_t)b * T * NF, T, t0, NF, nc, normalize_linear != 0);
  __syncthreads();
  const size_t rows = (size_t)gridDim.z * T;
  stft_partial_mel(mag, melT, f0, M, partial + ((size_t)tile * rows + (size_t)b * T) * M,
                   T, t0);
}

extern "C" int stft_fused_launch(const float* wav, const float* cosb,
                                 const float* sinb, const float* melT,
                                 float* partial, float* mel_out, float* lin_out,
                                 int B, int L, int T, int hop, int n0, int n_live,
                                 int NF, int NFp, int M, float ref_db, float min_db,
                                 float max_abs, int symmetric, int normalize_linear,
                                 int bf16, cudaStream_t stream) {
  if (NFp % STFT_FT != 0 || B < 1 || T < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  const int seg_len = (STFT_TF - 1) * hop + n_live;
  size_t smem = sizeof(float) * ((size_t)seg_len + 2 * STFT_KC * STFT_FT +
                                 (size_t)STFT_TF * STFT_FT);
  cudaError_t err = cudaFuncSetAttribute(
      stft_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = NFp / STFT_FT;
  dim3 grid((T + STFT_TF - 1) / STFT_TF, tiles, B);
  stft_fused_kernel<<<grid, STFT_THREADS, smem, stream>>>(
      wav, cosb, sinb, melT, partial, lin_out, L, T, hop, n0, n_live, NF, NFp, M,
      nc, normalize_linear, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)stft_mel_reduce(partial, mel_out, tiles, (long long)B * T * M, nc, stream);
}
