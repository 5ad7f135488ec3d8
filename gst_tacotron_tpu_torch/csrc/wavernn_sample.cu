// K5 — WaveRNN autoregressive mu-law sampling, every sample of every row in
// one launch.
//
// Replaces: gst_tacotron_tpu/ops/wavernn_pallas.py::wavernn_sample_pallas
//           (kernel _sample_kernel).
//
// Each step s, per row b:
//   x      = embed[prev] + cond[b, s / hop]        (frame-rate conditioning)
//   h      = Keras-v2 GRU step (z, r, n; reset_after) of (x, h)
//   logits = fc2(ReLU(fc1(h)))                      over K = 2**bits classes
//   class  = argmax(logits)                          (greedy), or
//            argmax(logits / temperature + gumbel)   (Gumbel-max sampling)
//   prev   = class
// with prev = K / 2 (the mu-law midpoint) and h = 0 before the first step.
// Ties take the lowest index, as torch.argmax and jnp.argmax do.
//
// The conditioning comes at frame rate, (B, T, C), and sample s reads frame
// s / hop: the TPU kernel's input repeated to sample rate would be 16.8 GB
// for a batch of 32 at 500 decode steps (256,000 samples of 512 floats).
//
// Gumbel noise: one Philox4x32-10 call per quad of classes, keyed by the
// seed and counted by (class >> 2, sample, stream 2, row) -- stream ids 0
// and 1 are the decode kernel's prenet layers -- giving a uniform strictly
// inside (0, 1) from unsigned bits (the TPU kernel's signed-bits bug class
// cannot occur) and g = -log(-log(u)). ops/philox.py draws the same stream.
//
// Bound on the H100 at config 5 (C = F = H = 512, K = 256; ~2.1 M weights,
// 8.4 MB): about 3.9 MFLOP a row and sample, 4.1 TFLOP for 32 rows of
// 32,768 samples, so the float32 pipe bounds it at about 61 ms (the inputs
// and outputs are a few MB). Every sample depends on the one before.
//
// Design: a first version. One block of 1024 threads per row runs every
// sample. The recurrent state, the step's input, gates, hidden FC and logits
// stay in shared memory; the weights stay L2-resident and every block
// streams all of them each step as GEMVs with float4 column reads (scalar
// where a width is not a multiple of 4), splitting the input dimension over
// threads when a product has fewer column quads than the block has threads.
// Streaming 8.4 MB from L2 into one SM per sample bounds it, tens of times
// its float32 bound; splitting the weights over SMs (a cluster or a grid
// barrier per step) is left for a later change.

#include "common.cuh"

#define WR_THREADS 1024

struct WaveWeights {
  const float *embed, *wi, *bi, *wh, *bh, *fc1, *fb1, *fc2, *fb2;
};

struct WaveDims {
  int T, hop, C, H, F, K;
};

// y[j] = act(bias[j] + sum_k x[k] * W[k * N + j]) for j < N; x and y in
// shared memory, red holds 4 * blockDim floats. Ends with a barrier.
__device__ void gemv(const float* __restrict__ W, const float* __restrict__ bias,
                     const float* x, int K, int N, float* y, float* red, bool relu) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if ((N & 3) == 0) {
    const int N4 = N >> 2;
    const int S = N4 >= nthr ? 1 : nthr / N4;
    const float4* W4 = reinterpret_cast<const float4*>(W);
    if (S == 1) {
      for (int j4 = tid; j4 < N4; j4 += nthr) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          const float4 wv = __ldg(W4 + (size_t)k * N4 + j4);
          const float xv = x[k];
          acc.x = fmaf(xv, wv.x, acc.x);
          acc.y = fmaf(xv, wv.y, acc.y);
          acc.z = fmaf(xv, wv.z, acc.z);
          acc.w = fmaf(xv, wv.w, acc.w);
        }
        const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = a[e] + bias[4 * j4 + e];
          y[4 * j4 + e] = relu ? fmaxf(v, 0.0f) : v;
        }
      }
      __syncthreads();
      return;
    }
    const int j4 = tid % N4, s = tid / N4;
    const int kc = (K + S - 1) / S;
    if (s < S) {
      const int k0 = s * kc, k1 = min(K, k0 + kc);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float4 wv = __ldg(W4 + (size_t)k * N4 + j4);
        const float xv = x[k];
        acc.x = fmaf(xv, wv.x, acc.x);
        acc.y = fmaf(xv, wv.y, acc.y);
        acc.z = fmaf(xv, wv.z, acc.z);
        acc.w = fmaf(xv, wv.w, acc.w);
      }
      reinterpret_cast<float4*>(red)[s * N4 + j4] = acc;
    }
    __syncthreads();
    for (int j = tid; j < N; j += nthr) {
      float v = 0.0f;
      for (int ss = 0; ss < S; ++ss) v += red[ss * N + j];
      v += bias[j];
      y[j] = relu ? fmaxf(v, 0.0f) : v;
    }
    __syncthreads();
    return;
  }
  // scalar columns
  const int S = N >= nthr ? 1 : nthr / N;
  const int j = tid % N, s = tid / N;
  const int kc = (K + S - 1) / S;
  if (S == 1) {
    for (int jj = tid; jj < N; jj += nthr) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(x[k], __ldg(W + (size_t)k * N + jj), acc);
      const float v = acc + bias[jj];
      y[jj] = relu ? fmaxf(v, 0.0f) : v;
    }
    __syncthreads();
    return;
  }
  if (s < S) {
    const int k0 = s * kc, k1 = min(K, k0 + kc);
    float acc = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc = fmaf(x[k], __ldg(W + (size_t)k * N + j), acc);
    red[s * N + j] = acc;
  }
  __syncthreads();
  for (int jj = tid; jj < N; jj += nthr) {
    float v = 0.0f;
    for (int ss = 0; ss < S; ++ss) v += red[ss * N + jj];
    v += bias[jj];
    y[jj] = relu ? fmaxf(v, 0.0f) : v;
  }
  __syncthreads();
}

// (value, index) argmax step: the larger value wins, the lower index on a tie.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(WR_THREADS)
wavernn_sample_kernel(const float* __restrict__ cond,   // (B, T, C)
                      WaveWeights w, WaveDims d,
                      int* __restrict__ classes,         // (B, T * hop)
                      unsigned long long seed, float temperature, int greedy) {
  extern __shared__ float smem[];
  const int C = d.C, H = d.H, F = d.F, K = d.K;
  float* red = smem;                     // first: float4 stores need 16 B alignment
  float* best_v = red + 4 * WR_THREADS;
  int* best_i = reinterpret_cast<int*>(best_v + 32);
  int* prev = best_i + 32;
  float* x = reinterpret_cast<float*>(prev + 1);
  float* h = x + C;
  float* gx = h + H;
  float* gh = gx + 3 * H;
  float* f1 = gh + 3 * H;
  float* lg = f1 + F;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int S = d.T * d.hop;
  const float* cond_b = cond + (size_t)b * d.T * C;
  int* out_b = classes + (size_t)b * S;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);

  for (int i = tid; i < H; i += nthr) h[i] = 0.0f;
  if (tid == 0) *prev = K / 2;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float* e = w.embed + (size_t)(*prev) * C;
    const float* cf = cond_b + (size_t)(s / d.hop) * C;
    for (int i = tid; i < C; i += nthr) x[i] = e[i] + cf[i];
    __syncthreads();

    gemv(w.wi, w.bi, x, C, 3 * H, gx, red, false);
    gemv(w.wh, w.bh, h, H, 3 * H, gh, red, false);
    for (int k = tid; k < H; k += nthr)
      h[k] = gru_update(gx[k], gx[H + k], gx[2 * H + k], gh[k], gh[H + k],
                        gh[2 * H + k], h[k]);
    __syncthreads();
    gemv(w.fc1, w.fb1, h, H, F, f1, red, true);
    gemv(w.fc2, w.fb2, f1, F, K, lg, red, false);

    // scores and argmax; each thread walks its class quads in order
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int q = tid; 4 * q < K; q += nthr) {
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (!greedy) {
        Philox4 p = philox4x32_10((uint32_t)q, (uint32_t)s, 2u, (uint32_t)b, k0, k1);
#pragma unroll
        for (int e = 0; e < 4; ++e) g[e] = -logf(-logf(uniform_open01(p.v[e])));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        if (k < K) argmax_merge(bv, bi, greedy ? lg[k] : lg[k] / temperature + g[e], k);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, o),
                   __shfl_xor_sync(0xffffffffu, bi, o));
    if (lane == 0) {
      best_v[warp] = bv;
      best_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? best_v[lane] : -INFINITY;
      bi = lane < nwarps ? best_i[lane] : 0x7fffffff;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, o),
                     __shfl_xor_sync(0xffffffffu, bi, o));
      if (lane == 0) {
        *prev = bi;
        out_b[s] = bi;
      }
    }
    __syncthreads();
  }
}

extern "C" int wavernn_sample_launch(const float* cond,
                                     const float* const* weights,  // host array, WaveWeights order
                                     const int* dims,              // host array, WaveDims order
                                     int* classes, int B,
                                     unsigned long long seed, float temperature,
                                     int greedy, cudaStream_t stream) {
  WaveWeights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < (int)(sizeof(WaveWeights) / sizeof(const float*)); ++i) wp[i] = weights[i];
  WaveDims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(WaveDims) / sizeof(int)); ++i) dp[i] = dims[i];
  const size_t floats = (size_t)d.C + 7 * d.H + d.F + d.K + 4 * WR_THREADS + 32 + 32 + 1;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wavernn_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wavernn_sample_kernel<<<B, WR_THREADS, smem, stream>>>(cond, w, d, classes, seed,
                                                         temperature, greedy);
  return (int)cudaGetLastError();
}
