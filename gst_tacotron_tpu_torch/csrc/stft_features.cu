// K3 — mel-STFT features in one launch: the windowed live taps of each
// frame through a shared-memory real FFT, the magnitude, the normalized-dB
// linear spectrogram (or the raw magnitude, normalize_linear = 0), then the
// mel over each filter's nonzero bins and its normalized-dB epilogue.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas_resident
//           (kernel _stft_resident_kernel).
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch,
// 4 launches per synthesis; n_fft 2048, 1025 bins, 80 mels): a real FFT of
// about 56 kFLOP a frame against 1.1 MB of wav read and 4.5 MB written a
// launch: the bytes bound it (about 1.7 us a launch at 3.35 TB/s).
//
// Design: K3' (stft_fused.cu) computes the same function, so both launch
// the one kernel of stft_wav.cuh: the mixed-radix FFT of fft.cuh for any
// hop | n_fft, each frame's transform in shared memory, or in a
// device-memory scratch when it does not fit. This source keeps K3's
// launcher, and with it K3's launch counter.
//
// bf16 mode (bf16 = 1): the resident Pallas kernel's bf16 operand mode
// (stft_features_pallas_resident(bf16=True), which the JAX feature
// extractor runs on its accelerator): frames and window-baked cos/sin bases
// rounded to bfloat16 with float32 sums, then the magnitude and the mel
// weights rounded to bfloat16 for the mel product, float32 sums. No FFT
// computes that function, so it runs the tensor-core kernel of
// stft_bf16.cuh (wgmma on TMA-fed bases; the design is there) with the bf16
// mel (MB = true). Bound: the dense products over the live taps, 4 * n_live
// * NF FLOPs a frame, 4.3 GFLOP a launch at the main-path shape, about 4.4
// us at 989 TFLOP/s (the bytes, about 1.7 us, do not bound it).

#include "stft_bf16.cuh"

// float32 (bf16 = 0): the FFT kernel of stft_wav.cuh; bf16 = 1: the
// tensor-core kernel on `bases` with the host plan `plan` (scratch: its
// magnitudes past 8 windows).
extern "C" int stft_features_launch(const float* wav, const float* table, const float* window,
                                    const int* mel_lo, const int* mel_off, const float* mel_w,
                                    const int* bases, const int* plan, float* mel_out,
                                    float* lin_out, int B, int L, int T, int hop, int n0,
                                    int n_live, int n_fft, int M, int fr, int slots,
                                    const int* radix, int stages, float ref_db, float min_db,
                                    float max_abs, int symmetric, int normalize_linear,
                                    int bf16, float* scratch, cudaStream_t stream) {
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  if (bf16) {
    if (B < 1 || T < 1 || B > 65535 || n0 < 0 || n_live < 1 || n0 + n_live > n_fft)
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(wav, bases, plan, mel_lo, mel_off, mel_w, mel_out, lin_out, scratch,
                            B, L, T, hop, n0, n_live, n_fft / 2 + 1, M, nc, normalize_linear,
                            true, stream);
  }
  return (int)launch_stft_wav(wav, table, window, mel_lo, mel_off, mel_w, mel_out, lin_out, B,
                              L, T, hop, n0, n_live, n_fft, M, fr, slots, radix, stages, nc,
                              normalize_linear, scratch, stream);
}
