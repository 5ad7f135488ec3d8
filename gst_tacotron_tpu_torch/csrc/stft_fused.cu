// K3' — mel-STFT features of a wav for any hop | n_fft, K3's function
// (stft_features.cu), and the JAX kernel's bf16_bases mode on the tensor
// cores.
//
// Replaces: gst_tacotron_tpu/ops/stft_pallas.py::stft_features_pallas_fused
//           (kernel _stft_fused_kernel).
//
// Input: (B, L) float32 wav, preemphasized, reflect-padded at the centre per
// utterance and zero-padded to the bucket length; frame t covers samples
// [t*hop, t*hop + n_fft), of which only the window's live taps
// [n0, n0 + n_live) are nonzero after windowing. Output: mel (B, T, M)
// normalized dB, linear (B, T, NF) normalized dB or (normalize_linear = 0)
// the magnitude.
//
// Bound on the H100 at the main-path shape (8 wavs of 128 frames a launch;
// n_fft 2048, n_live 1024, 1025 bins, 80 mels), float32: a real FFT, about
// 56 kFLOP a frame, against 1.1 MB of wav read and 4.5 MB of outputs
// written: the bytes bound it (about 1.7 us at 3.35 TB/s).
//
// Design: float32 is K3's function, so K3 and K3' launch the one kernel of
// stft_wav.cuh (the mixed-radix FFT in shared memory, or on a device-memory
// scratch past one block's); this source has K3' own launcher and
// launch counter.
//
// bf16 bases (stft_bf16.cuh::stft_bf16_wgmma_kernel<false>, shared with
// K3's bf16 mode, which stft_bf16.cuh describes): the frames and the
// window-baked cos/sin bases rounded to bfloat16, their products summed in
// float32 on wgmma with the bases brought in by TMA (the TPU kernel's MXU
// form; no FFT computes this function); the mel stays float32. Bound: 2 * 2
// * n_live * NF FLOPs a frame, 4.3 GFLOP a launch, about 4.4 us at the 989
// TFLOP/s of the bf16 tensor cores (the bytes, about 1.7 us, do not bound
// it). Any n_fft: past 8 bin windows the magnitudes go through a
// device-memory scratch.

#include "stft_bf16.cuh"

// float32 (bf16 = 0): `fr` frames a block, or fr = 0 and `slots` blocks an
// utterance on `scratch` (stft_wav.cuh); bf16 bases: the wgmma kernel on
// `bases` with the host plan `plan` (scratch: its magnitudes past 8 windows).
extern "C" int stft_fused_launch(const float* wav, const float* table, const float* window,
                                 const int* mel_lo, const int* mel_off, const float* mel_w,
                                 const int* bases, const int* plan, float* mel_out,
                                 float* lin_out, int B, int L, int T, int hop, int n0,
                                 int n_live, int n_fft, int M, int fr, int slots,
                                 const int* radix, int stages, float ref_db, float min_db,
                                 float max_abs, int symmetric, int normalize_linear, int bf16,
                                 float* scratch, cudaStream_t stream) {
  if (B < 1 || T < 1 || B > 65535 || n0 < 0 || n_live < 1 || n0 + n_live > n_fft)
    return (int)cudaErrorInvalidValue;
  NormConsts nc{ref_db, min_db, max_abs, symmetric};
  if (bf16)
    return (int)launch_bf16(wav, bases, plan, mel_lo, mel_off, mel_w, mel_out, lin_out, scratch,
                            B, L, T, hop, n0, n_live, n_fft / 2 + 1, M, nc, normalize_linear,
                            false, stream);
  return (int)launch_stft_wav(wav, table, window, mel_lo, mel_off, mel_w, mel_out, lin_out, B,
                              L, T, hop, n0, n_live, n_fft, M, fr, slots, radix, stages, nc,
                              normalize_linear, scratch, stream);
}
