// K4 — the whole fixed-length autoregressive decode (Bahdanau or
// location-sensitive attention) in one launch.
//
// Replaces: gst_tacotron_tpu/ops/decode_pallas.py::decode_scan_pallas
//           (kernel _decode_kernel), both branches.
//
// Each step, per utterance: prenet (2 x dense + ReLU, optional inverted
// dropout) of the last frame -> attention GRU over [prenet ; context] ->
// query projection -> scores v . tanh(keys + q), -1e9 at masked positions ->
// softmax masked again, with its denominator clamped at 1e-9 -> context
// sum_t align[t] * memory[t] -> decoder input projection of [query ; context]
// -> two residual GRUs -> one packed frame + stop projection of
// [h ; context] -> the frame in slot r-1 feeds the next step. Position 0 is
// always valid, so a row of length 0 gets a one-hot alignment.
//
// Location term: the score's tanh argument gains
// loc[t][a] = sum_{j,c} feat_c[t + j - (k-1)/2] * loca[j*c_n + c][a] over the
// previous alignment (c = 0) and, when cumulative, the running sum of
// alignments (c = 1), zero outside [0, T). The folded taps loca (k*c_n, A;
// 62 x 256 floats = 63.5 KB at config 3) and both alignment rows, zero-padded
// by k-1, stay in shared memory for the whole decode: a direct 31-tap sum
// with loca read conflict-free across lanes and the features broadcast. It
// costs about 2*T*k*c_n*A FLOP a step and row (2 MFLOP at config 3) and no
// device-memory traffic. The TPU kernel's banded-Toeplitz matrix (an MXU
// device for the same sum, up to 48 MB) is not carried over. After the
// softmax: prev = align, cum += align, as the JAX code orders it. Bahdanau
// attention runs the same loop with one zero tap (k = c_n = 1), which adds
// exactly 0 to each argument.
//
// Dropout draws one Philox4x32-10 number per prenet unit, keyed by the seed
// and counted by (unit, step, layer, row), as a uniform strictly inside
// (0, 1); a unit is kept when the draw is >= rate and then scaled by
// 1 / (1 - rate). The stream differs from jax.random's and the TPU's.
//
// Bound on the H100 at the main-path shape (B=32, T=64, memory 512, keys
// 256, 200 steps at r=2; ~1.9 M weights): about 3.9 MFLOP a step and row,
// 25 GFLOP per synthesis against ~20 MB of inputs, weights and outputs, so
// the float32 pipe bounds it (about 0.37 ms at 67 TFLOP/s). Each step
// depends on the one before. Location-sensitive at config 3 (the same
// widths, r=1, 1000 steps): about 5.9 MFLOP a step and row, 189 GFLOP per
// synthesis, so about 2.8 ms.
//
// Design: one block of 1024 threads per utterance runs all steps. Every
// recurrent state (both attention and decoder GRU states, the context, the
// last frame) and every per-step vector stays in shared memory for the whole
// decode. The weights (~7.7 MB) are read from device memory each step, where
// they stay L2-resident; each product is a GEMV whose columns map to
// consecutive threads (coalesced weight reads), split over the input
// dimension when it has fewer columns than the block has threads. This is
// slow: every block streams all weights every step. Splitting the weights
// over SMs with a grid-wide step barrier is left for a later change.

#include "common.cuh"

#define DEC_THREADS 1024

struct DecodeWeights {
  const float *pw1, *pb1, *pw2, *pb2;
  const float *awi, *abi, *awh, *abh;
  const float *qproj, *vvec, *loca;
  const float *dwi, *dbi;
  const float *g1wi, *g1bi, *g1wh, *g1bh;
  const float *g2wi, *g2bi, *g2wh, *g2bh;
  const float *fw, *fb;
};

struct DecodeDims {
  int T, S, r, NM, P1, P2, Ha, A, Hd, Md, ld_pw1, ld_fw;
  int loc_k, loc_c;  // location taps, feature channels
};

// Scores: each warp takes SC_TT consecutive positions, its lanes the
// attention columns, so one read of a tap column serves SC_TT positions.
#define SC_TT 2

// y[j] = bias[j] + sum_k x[k] * W[k * ld + j] for j < N; x and y in shared
// memory (distinct), red holds blockDim floats. Ends with a barrier.
__device__ void gemv(const float* __restrict__ W, int ld,
                     const float* __restrict__ bias, const float* x, int K,
                     int N, float* y, float* red) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int S = nthr / N;
  if (S <= 1) {
    for (int j = tid; j < N; j += nthr) {
      float acc = bias ? bias[j] : 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(x[k], __ldg(W + (size_t)k * ld + j), acc);
      y[j] = acc;
    }
    __syncthreads();
    return;
  }
  const int j = tid % N, s = tid / N;
  const int kc = (K + S - 1) / S;
  if (s < S) {
    const int k0 = s * kc, k1 = min(K, k0 + kc);
    float acc = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc = fmaf(x[k], __ldg(W + (size_t)k * ld + j), acc);
    red[s * N + j] = acc;
  }
  __syncthreads();
  for (int jj = tid; jj < N; jj += nthr) {
    float acc = bias ? bias[jj] : 0.0f;
    for (int ss = 0; ss < S; ++ss) acc += red[ss * N + jj];
    y[jj] = acc;
  }
  __syncthreads();
}

__device__ float block_reduce(float v, bool is_max, float* scratch32) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) scratch32[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? scratch32[lane] : (is_max ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) scratch32[0] = v;
  }
  __syncthreads();
  v = scratch32[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ float prenet_unit(float v, int unit, int step,
                                             int layer, int row,
                                             unsigned long long seed,
                                             float rate, int use_dropout) {
  v = fmaxf(v, 0.0f);
  if (!use_dropout) return v;
  Philox4 p = philox4x32_10((uint32_t)(unit >> 2), (uint32_t)step,
                            (uint32_t)layer, (uint32_t)row,
                            (uint32_t)seed, (uint32_t)(seed >> 32));
  float u = uniform_open01(p.v[unit & 3]);
  return u >= rate ? v / (1.0f - rate) : 0.0f;
}

__global__ void __launch_bounds__(DEC_THREADS)
decode_scan_kernel(const float* __restrict__ memory,   // (B, T, Md)
                   const float* __restrict__ keys,     // (B, T, A)
                   const int* __restrict__ lengths,    // (B,)
                   DecodeWeights w, DecodeDims d,
                   float* __restrict__ mel_out,        // (B, S*r, NM)
                   float* __restrict__ stop_out,       // (B, S*r)
                   float* __restrict__ align_out,      // (B, S, T)
                   unsigned long long seed, float rate, int use_dropout) {
  extern __shared__ float smem[];
  const int G = 3 * max(d.Ha, d.Hd);
  const int XIN = max(d.P2, max(d.Ha, d.Hd)) + d.Md;
  float* h_attn = smem;
  float* h_d1 = h_attn + d.Ha;
  float* h_d2 = h_d1 + d.Hd;
  float* ctx = h_d2 + d.Hd;
  float* last = ctx + d.Md;
  float* p1 = last + d.NM;
  float* p2 = p1 + d.P1;
  float* xin = p2 + d.P2;
  float* gx = xin + XIN;
  float* gh = gx + G;
  float* q = gh + G;
  float* sc = q + d.A;
  float* hdec = sc + d.T;
  float* outv = hdec + d.Hd;
  float* red = outv + d.r * d.NM + d.r;
  float* scratch32 = red + DEC_THREADS;
  // location state
  const int KC = d.loc_k * d.loc_c, FW = d.T + d.loc_k - 1, pad = (d.loc_k - 1) / 2;
  float* loca = scratch32 + 32;          // (KC, A) folded taps
  float* fpad = loca + KC * d.A;         // (loc_c, FW): prev, cum, zero-padded

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int len = lengths[b];
  const float* mem_b = memory + (size_t)b * d.T * d.Md;
  const float* keys_b = keys + (size_t)b * d.T * d.A;
  const int n_out = d.r * d.NM + d.r;

  for (int i = tid; i < d.Ha; i += nthr) h_attn[i] = 0.0f;
  for (int i = tid; i < d.Hd; i += nthr) h_d1[i] = h_d2[i] = 0.0f;
  for (int i = tid; i < d.Md; i += nthr) ctx[i] = 0.0f;
  for (int i = tid; i < d.NM; i += nthr) last[i] = 0.0f;
  for (int i = tid; i < KC * d.A; i += nthr) loca[i] = w.loca[i];
  // the initial alignment state: a delta at position 0, zero cumulative
  for (int i = tid; i < d.loc_c * FW; i += nthr) fpad[i] = (i == pad) ? 1.0f : 0.0f;
  __syncthreads();

  for (int step = 0; step < d.S; ++step) {
    // prenet
    gemv(w.pw1, d.ld_pw1, w.pb1, last, d.NM, d.P1, p1, red);
    for (int i = tid; i < d.P1; i += nthr)
      p1[i] = prenet_unit(p1[i], i, step, 0, b, seed, rate, use_dropout);
    __syncthreads();
    gemv(w.pw2, d.P2, w.pb2, p1, d.P1, d.P2, p2, red);
    for (int i = tid; i < d.P2; i += nthr)
      xin[i] = prenet_unit(p2[i], i, step, 1, b, seed, rate, use_dropout);
    for (int i = tid; i < d.Md; i += nthr) xin[d.P2 + i] = ctx[i];
    __syncthreads();

    // attention GRU over [prenet ; context]
    gemv(w.awi, 3 * d.Ha, w.abi, xin, d.P2 + d.Md, 3 * d.Ha, gx, red);
    gemv(w.awh, 3 * d.Ha, w.abh, h_attn, d.Ha, 3 * d.Ha, gh, red);
    for (int k = tid; k < d.Ha; k += nthr)
      h_attn[k] = gru_update(gx[k], gx[d.Ha + k], gx[2 * d.Ha + k], gh[k],
                             gh[d.Ha + k], gh[2 * d.Ha + k], h_attn[k]);
    __syncthreads();

    // scores and masked softmax
    gemv(w.qproj, d.A, nullptr, h_attn, d.Ha, d.A, q, red);
    for (int t0 = warp * SC_TT; t0 < d.T; t0 += nwarps * SC_TT) {
      float s[SC_TT];
#pragma unroll
      for (int i = 0; i < SC_TT; ++i) s[i] = 0.0f;
      for (int a = lane; a < d.A; a += 32) {
        float loc[SC_TT];
#pragma unroll
        for (int i = 0; i < SC_TT; ++i) loc[i] = 0.0f;
        for (int j = 0; j < d.loc_k; ++j) {
          for (int c = 0; c < d.loc_c; ++c) {
            const float wv = loca[(j * d.loc_c + c) * d.A + a];
            const float* f = fpad + c * FW + j + t0;
#pragma unroll
            for (int i = 0; i < SC_TT; ++i)
              if (t0 + i < d.T) loc[i] = fmaf(f[i], wv, loc[i]);
          }
        }
        const float qa = q[a], va = w.vvec[a];
#pragma unroll
        for (int i = 0; i < SC_TT; ++i)
          if (t0 + i < d.T)
            s[i] = fmaf(va, tanhf(keys_b[(size_t)(t0 + i) * d.A + a] + qa + loc[i]), s[i]);
      }
#pragma unroll
      for (int i = 0; i < SC_TT; ++i) {
        float v = s[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        const int t = t0 + i;
        if (lane == 0 && t < d.T) sc[t] = (t < len || t == 0) ? v : -1e9f;
      }
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int t = tid; t < d.T; t += nthr) mx = fmaxf(mx, sc[t]);
    mx = block_reduce(mx, true, scratch32);
    float sum = 0.0f;
    for (int t = tid; t < d.T; t += nthr) {
      float e = (t < len || t == 0) ? expf(sc[t] - mx) : 0.0f;
      sc[t] = e;
      sum += e;
    }
    sum = fmaxf(block_reduce(sum, false, scratch32), 1e-9f);
    float* al = align_out + ((size_t)b * d.S + step) * d.T;
    for (int t = tid; t < d.T; t += nthr) {
      float a = sc[t] / sum;
      sc[t] = a;
      al[t] = a;
      fpad[pad + t] = a;                              // prev = align
      if (d.loc_c == 2) fpad[FW + pad + t] += a;      // cum += align
    }
    __syncthreads();

    // context
    for (int m = tid; m < d.Md; m += nthr) {
      float acc = 0.0f;
      for (int t = 0; t < d.T; ++t) acc = fmaf(sc[t], mem_b[(size_t)t * d.Md + m], acc);
      ctx[m] = acc;
    }
    __syncthreads();

    // decoder input projection of [query ; context], two residual GRUs
    for (int i = tid; i < d.Ha; i += nthr) xin[i] = h_attn[i];
    for (int i = tid; i < d.Md; i += nthr) xin[d.Ha + i] = ctx[i];
    __syncthreads();
    gemv(w.dwi, d.Hd, w.dbi, xin, d.Ha + d.Md, d.Hd, hdec, red);
    gemv(w.g1wi, 3 * d.Hd, w.g1bi, hdec, d.Hd, 3 * d.Hd, gx, red);
    gemv(w.g1wh, 3 * d.Hd, w.g1bh, h_d1, d.Hd, 3 * d.Hd, gh, red);
    for (int k = tid; k < d.Hd; k += nthr) {
      float h = gru_update(gx[k], gx[d.Hd + k], gx[2 * d.Hd + k], gh[k],
                           gh[d.Hd + k], gh[2 * d.Hd + k], h_d1[k]);
      h_d1[k] = h;
      hdec[k] += h;
    }
    __syncthreads();
    gemv(w.g2wi, 3 * d.Hd, w.g2bi, hdec, d.Hd, 3 * d.Hd, gx, red);
    gemv(w.g2wh, 3 * d.Hd, w.g2bh, h_d2, d.Hd, 3 * d.Hd, gh, red);
    for (int k = tid; k < d.Hd; k += nthr) {
      float h = gru_update(gx[k], gx[d.Hd + k], gx[2 * d.Hd + k], gh[k],
                           gh[d.Hd + k], gh[2 * d.Hd + k], h_d2[k]);
      h_d2[k] = h;
      hdec[k] += h;
    }
    __syncthreads();

    // packed frame + stop projection of [h ; context]
    for (int i = tid; i < d.Hd; i += nthr) xin[i] = hdec[i];
    for (int i = tid; i < d.Md; i += nthr) xin[d.Hd + i] = ctx[i];
    __syncthreads();
    gemv(w.fw, d.ld_fw, w.fb, xin, d.Hd + d.Md, n_out, outv, red);
    const size_t frame0 = (size_t)b * d.S * d.r + (size_t)step * d.r;
    for (int e = tid; e < d.r * d.NM; e += nthr) mel_out[frame0 * d.NM + e] = outv[e];
    for (int e = tid; e < d.r; e += nthr) stop_out[frame0 + e] = outv[d.r * d.NM + e];
    for (int i = tid; i < d.NM; i += nthr) last[i] = outv[(d.r - 1) * d.NM + i];
    __syncthreads();
  }
}

extern "C" int decode_scan_launch(const float* memory, const float* keys,
                                  const int* lengths,
                                  const float* const* weights,  // host array, DecodeWeights order
                                  const int* dims,              // host array, DecodeDims order
                                  float* mel_out, float* stop_out,
                                  float* align_out, int B,
                                  unsigned long long seed, float rate,
                                  int use_dropout, cudaStream_t stream) {
  DecodeWeights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < (int)(sizeof(DecodeWeights) / sizeof(const float*)); ++i) wp[i] = weights[i];
  DecodeDims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(DecodeDims) / sizeof(int)); ++i) dp[i] = dims[i];
  const int G = 3 * (d.Ha > d.Hd ? d.Ha : d.Hd);
  int hmax = d.Ha > d.Hd ? d.Ha : d.Hd;
  const int XIN = (d.P2 > hmax ? d.P2 : hmax) + d.Md;
  size_t floats = (size_t)d.Ha + 2 * d.Hd + d.Md + d.NM + d.P1 + d.P2 + XIN +
                  2 * G + d.A + d.T + d.Hd + d.r * d.NM + d.r + DEC_THREADS + 32 +
                  (size_t)d.loc_k * d.loc_c * d.A + (size_t)d.loc_c * (d.T + d.loc_k - 1);
  size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_scan_kernel<<<B, DEC_THREADS, smem, stream>>>(
      memory, keys, lengths, w, d, mel_out, stop_out, align_out, seed, rate,
      use_dropout);
  return (int)cudaGetLastError();
}
