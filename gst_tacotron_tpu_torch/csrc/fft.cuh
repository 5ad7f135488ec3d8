// FFT device code of the mel-STFT kernels (K3, K3', K3''): a Stockham
// (self-sorting) FFT over several transforms of one block (fft_mixed): any
// length n, radix 4 while it divides, one radix 2, then radix 3, radix 5 and
// a generic direct DFT for each other (odd prime) factor, run from an
// FftPlan; and the split step that turns an n-point complex FFT of a packed
// 2n-point real frame into its n + 1 bins (rfft_split_mod). The buffers are
// in shared memory, or for a transform too large for it, in device memory.
//
// Stage with radix R after sub-transforms of length p are done (p = 1, R1,
// R1*R2, ...): for i in [0, n/R), k = i mod p, inputs u_q = x[i + q*n/R]
// (q < R), twiddled u_q *= exp(-2*pi*i*k*q / (R*p)), then an R-point DFT
// whose outputs go to y[(i - k)*R + k + q*p]. The twiddles come from a table
// built on the host in float64 (ops/stft.py::fft_plan): stage by stage,
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

// The table (ops/stft.py::fft_plan): the stages' twiddles ((R-1)*p entries
// each, n - 1 in all), then the roots exp(-2*pi*i*m/R), m < R, of each
// generic stage (R > 5) in order, then for a packed real frame the n + 1
// split twiddles. For a power of two the stages are radix 4 with at most
// one radix 2, as in K3's earlier power-of-two FFT, whose bits K3 keeps.

#define FFT_MAX_STAGES 32

struct FftPlan {
  int n;       // transform length
  int stages;  // radix[0 .. stages)
  int radix[FFT_MAX_STAGES];
};

// Entries of the table before the split twiddles.
__host__ __device__ inline int fft_plan_table_head(const FftPlan& plan) {
  int size = plan.n - 1;
  for (int s = 0; s < plan.stages; ++s)
    if (plan.radix[s] > 5) size += plan.radix[s];
  return size;
}

// In-place R-point DFTs, u[j] <- sum_q u[q] exp(-2*pi*i*j*q/R).
__device__ __forceinline__ void dft_small(float2 (&u)[2]) {
  const float2 a = u[0], b = u[1];
  u[0] = cadd(a, b);
  u[1] = csub(a, b);
}

__device__ __forceinline__ void dft_small(float2 (&u)[3]) {
  const float kSin3 = 0.866025403784438647f;  // sin(2*pi/3)
  const float2 s = cadd(u[1], u[2]), d = csub(u[1], u[2]);
  const float2 t = make_float2(u[0].x - 0.5f * s.x, u[0].y - 0.5f * s.y);
  const float2 r = make_float2(kSin3 * d.y, -kSin3 * d.x);  // -i * sin(2pi/3) * d
  u[0] = cadd(u[0], s);
  u[1] = cadd(t, r);
  u[2] = csub(t, r);
}

// The radix-4 butterfly.
__device__ __forceinline__ void dft_small(float2 (&u)[4]) {
  const float2 v0 = cadd(u[0], u[2]), v1 = csub(u[0], u[2]), v2 = cadd(u[1], u[3]);
  const float2 d = csub(u[1], u[3]);
  const float2 v3 = make_float2(d.y, -d.x);  // -i * (u1 - u3)
  u[0] = cadd(v0, v2);
  u[1] = cadd(v1, v3);
  u[2] = csub(v0, v2);
  u[3] = csub(v1, v3);
}

__device__ __forceinline__ void dft_small(float2 (&u)[5]) {
  const float c1 = 0.309016994374947424f, c2 = -0.809016994374947424f;  // cos(2pi/5), cos(4pi/5)
  const float s1 = 0.951056516295153572f, s2 = 0.587785252292473129f;   // sin(2pi/5), sin(4pi/5)
  const float2 a1 = cadd(u[1], u[4]), b1 = csub(u[1], u[4]);
  const float2 a2 = cadd(u[2], u[3]), b2 = csub(u[2], u[3]);
  const float2 p1 = make_float2(u[0].x + c1 * a1.x + c2 * a2.x, u[0].y + c1 * a1.y + c2 * a2.y);
  const float2 p2 = make_float2(u[0].x + c2 * a1.x + c1 * a2.x, u[0].y + c2 * a1.y + c1 * a2.y);
  const float2 q1 = make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y);
  const float2 q2 = make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y);
  const float2 r1 = make_float2(q1.y, -q1.x), r2 = make_float2(q2.y, -q2.x);  // -i * q
  u[0] = cadd(u[0], cadd(a1, a2));
  u[1] = cadd(p1, r1);
  u[4] = csub(p1, r1);
  u[2] = cadd(p2, r2);
  u[3] = csub(p2, r2);
}

// One radix-R stage (R = 2, 3, 4, 5) over `count` transforms of n points:
// transform f's input load(f, i), output y[f * stride + ...], tw this
// stage's (R-1)*p table entries (unused at p = 1).
template <int R, class Load>
__device__ __forceinline__ void fft_stage_fixed(Load load, float2* y, int stride, int n,
                                                int count, int p, const float2* tw) {
  const int m = n / R;
  for (int e = threadIdx.x; e < count * m; e += blockDim.x) {
    const int f = e / m, i = e - f * m;
    const int k = i % p;
    float2 u[R];
#pragma unroll
    for (int q = 0; q < R; ++q) u[q] = load(f, i + q * m);
    if (p > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) u[q] = cmul(u[q], tw[(q - 1) * p + k]);
    }
    dft_small(u);
    float2* yr = y + f * stride + (i - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) yr[q * p] = u[q];
  }
}

// A generic stage: a direct R-point DFT (any R; the plan uses it for odd
// primes past 5, and R = 1 copies) from the root table roots[m] =
// exp(-2*pi*i*m/R). One thread an output (f, i, j), j outermost so that
// neighbouring lanes read neighbouring inputs: it reads and twiddles its R
// inputs, O(R) work, nothing held in registers, and all count * n outputs
// spread over the block even when m = n / R is small.
template <class Load>
__device__ __forceinline__ void fft_stage_generic(Load load, float2* y, int stride, int n,
                                                  int count, int R, int p, const float2* tw,
                                                  const float2* roots) {
  const int m = n / R, cm = count * m;
  for (int e = threadIdx.x; e < cm * R; e += blockDim.x) {
    const int j = e / cm, fi = e - j * cm;
    const int f = fi / m, i = fi - f * m;
    const int k = i % p;
    float2 acc = load(f, i);
    int r = 0;  // j * q mod R
    for (int q = 1; q < R; ++q) {
      r += j;
      if (r >= R) r -= R;
      float2 u = load(f, i + q * m);
      if (p > 1) u = cmul(u, tw[(q - 1) * p + k]);
      acc = cadd(acc, cmul(u, roots[r]));
    }
    y[f * stride + (i - k) * R + k + j * p] = acc;
  }
}

template <class Load>
__device__ __forceinline__ void fft_stage_any(Load load, float2* y, int stride, int n,
                                              int count, int R, int p, const float2* tw,
                                              const float2* roots) {
  switch (R) {
    case 4: fft_stage_fixed<4>(load, y, stride, n, count, p, tw); break;
    case 2: fft_stage_fixed<2>(load, y, stride, n, count, p, tw); break;
    case 3: fft_stage_fixed<3>(load, y, stride, n, count, p, tw); break;
    case 5: fft_stage_fixed<5>(load, y, stride, n, count, p, tw); break;
    default: fft_stage_generic(load, y, stride, n, count, R, p, tw, roots);
  }
}

// Forward FFT of `count` transforms of plan.n points by all threads of the
// block, stage by stage as the plan lists them. The first stage reads
// load(f, i), so the caller can form its input on the fly (and may keep that
// input in b); the rest ping-pong between a and b (row stride `stride`
// float2 each). tw is the plan's table (device memory; read through the
// cache). Returns the buffer holding the result; the other one is free.
// Ends with a barrier.
template <class Load>
__device__ float2* fft_mixed(Load load, float2* a, float2* b, int stride, const FftPlan& plan,
                             int count, const float2* __restrict__ tw) {
  const int n = plan.n;
  const float2* roots = tw + (n - 1);
  int R = plan.radix[0];
  fft_stage_any(load, a, stride, n, count, R, 1, tw, roots);
  const float2* t = tw + (R - 1);
  if (R > 5) roots += R;
  int p = R;
  float2 *x = a, *y = b;
  for (int s = 1; s < plan.stages; ++s) {
    R = plan.radix[s];
    __syncthreads();
    const float2* xs = x;
    fft_stage_any([xs, stride](int f, int i) { return xs[f * stride + i]; }, y, stride, n,
                  count, R, p, t, roots);
    t += (R - 1) * p;
    if (R > 5) roots += R;
    p *= R;
    float2* sw = x;
    x = y;
    y = sw;
  }
  __syncthreads();
  return x;
}

// Bin k (0 <= k <= n) of the real 2n-point frame x whose samples were packed
// as z[m] = x[2m] + i*x[2m+1] and transformed to Z (n points):
// X[k] = E[k] + w^k O[k], E = (Z[k] + conj Z[n-k]) / 2 the even samples' FFT,
// O = -i (Z[k] - conj Z[n-k]) / 2 the odd ones', w^k = split[k].
__device__ __forceinline__ float2 rfft_split_mod(const float2* Z, int n, int k,
                                                 const float2* split) {
  const float2 a = Z[k % n], c = Z[(n - k) % n];
  const float2 ev = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  const float2 od = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
  return cadd(ev, cmul(split[k], od));
}
