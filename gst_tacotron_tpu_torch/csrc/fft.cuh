// Shared-memory FFT device code for the mel-STFT kernels: a Stockham
// (self-sorting) FFT of power-of-two length n over several transforms of one
// block, radix 4 with one radix-2 stage last when log2 n is odd, and the
// split step that turns an n-point complex FFT of a packed 2n-point real
// frame into its n + 1 bins.
//
// Stage with radix R after sub-transforms of length p are done (p = 1, R1,
// R1*R2, ...): for i in [0, n/R), k = i mod p, inputs u_q = x[i + q*n/R]
// (q < R), twiddled u_q *= exp(-2*pi*i*k*q / (R*p)), then an R-point DFT
// whose outputs go to y[(i - k)*R + k + q*p]. The twiddles come from a table
// built on the host in float64 (ops/stft.py::fft_tables): stage by stage,
// q-major, p entries for each q >= 1 ([q-1][k]), so consecutive threads read
// consecutive entries. Its n - 1 entries are followed by the n + 1 split
// twiddles exp(-2*pi*i*k / (2n)), k = 0..n.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-4 stage over `count` transforms of n points, transform f's
// input load(f, i) and output y[f * stride + ...]; tw is this stage's
// 3p-entry slice of the table (unused at p = 1, where every twiddle is 1).
template <class Load>
__device__ __forceinline__ void fft_stage4(Load load, float2* y, int stride, int n,
                                           int count, int p, const float2* tw) {
  const int q = n >> 2;
  const int qlog = __ffs(q) - 1;
  for (int e = threadIdx.x; e < count * q; e += blockDim.x) {
    const int f = e >> qlog, i = e & (q - 1);
    const int k = i & (p - 1);
    float2 u0 = load(f, i), u1 = load(f, i + q), u2 = load(f, i + 2 * q),
           u3 = load(f, i + 3 * q);
    if (p > 1) {
      u1 = cmul(u1, tw[k]);
      u2 = cmul(u2, tw[p + k]);
      u3 = cmul(u3, tw[2 * p + k]);
    }
    const float2 v0 = cadd(u0, u2), v1 = csub(u0, u2), v2 = cadd(u1, u3);
    const float2 d = csub(u1, u3);
    const float2 v3 = make_float2(d.y, -d.x);  // -i * (u1 - u3)
    float2* yr = y + f * stride + ((i - k) << 2) + k;
    yr[0] = cadd(v0, v2);
    yr[p] = cadd(v1, v3);
    yr[2 * p] = csub(v0, v2);
    yr[3 * p] = csub(v1, v3);
  }
}

// The radix-2 stage (p = n / 2), the last one when log2 n is odd.
__device__ __forceinline__ void fft_stage2(const float2* x, float2* y, int stride, int n,
                                           int count, int p, const float2* tw) {
  const int q = n >> 1;
  const int qlog = __ffs(q) - 1;
  for (int e = threadIdx.x; e < count * q; e += blockDim.x) {
    const int f = e >> qlog, i = e & (q - 1);
    const int k = i & (p - 1);
    const float2 u0 = x[f * stride + i];
    const float2 u1 = cmul(x[f * stride + i + q], tw[k]);
    float2* yr = y + f * stride + ((i - k) << 1) + k;
    yr[0] = cadd(u0, u1);
    yr[p] = csub(u0, u1);
  }
}

// Forward FFT of `count` transforms of n points (n a power of two, n >= 4)
// by all threads of the block. The first stage reads load(f, i), so the
// caller can form its input on the fly; the rest ping-pong between a and b
// (row stride `stride` float2 each). Returns the buffer holding the result;
// the other one is free. Ends with a barrier.
template <class Load>
__device__ float2* fft_pow2(Load load, float2* a, float2* b, int stride, int n, int count,
                            const float2* tw) {
  fft_stage4(load, a, stride, n, count, 1, tw);
  const float2* t = tw + 3;
  float2 *x = a, *y = b;
  int p = 4;
  for (; 4 * p <= n; p *= 4) {
    __syncthreads();
    const float2* xs = x;
    fft_stage4([xs, stride](int f, int i) { return xs[f * stride + i]; }, y, stride, n,
               count, p, t);
    t += 3 * p;
    float2* s = x;
    x = y;
    y = s;
  }
  if (p < n) {
    __syncthreads();
    fft_stage2(x, y, stride, n, count, p, t);
    float2* s = x;
    x = y;
    y = s;
  }
  __syncthreads();
  return x;
}

// Bin k (0 <= k <= n) of the real 2n-point frame x whose samples were packed
// as z[m] = x[2m] + i*x[2m+1] and transformed to Z (n points):
// X[k] = E[k] + w^k O[k], E = (Z[k] + conj Z[n-k]) / 2 the even samples' FFT,
// O = -i (Z[k] - conj Z[n-k]) / 2 the odd ones', w^k = split[k].
__device__ __forceinline__ float2 rfft_split(const float2* Z, int n, int k,
                                             const float2* split) {
  const float2 a = Z[k & (n - 1)], c = Z[(n - k) & (n - 1)];
  const float2 ev = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  const float2 od = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
  return cadd(ev, cmul(split[k], od));
}
