// K5 — WaveRNN autoregressive mu-law sampling, every sample of up to 32 rows
// in one persistent launch.
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
// Gumbel noise: one Philox4x32-10 call per quad of classes, keyed by the
// seed and counted by (class >> 2, sample, stream 2, row0 + row) -- stream
// ids 0 and 1 are the decode kernel's prenet layers; row0 is the launch's
// first row in the global batch -- giving a uniform strictly inside (0, 1)
// and g = -log(-log(u)). ops/philox.py draws the same stream.
//
// Bound on the H100 at config 5 (C = F = H = 512, K = 256, 32 rows of
// 32,768 samples): the function as the TPU kernel computes it, with the
// input product every sample, is about 3.9 MFLOP a row and sample, 4.1 TFLOP
// (61.5 ms at 67 TFLOP/s float32). The input product is linear in
// (embed[prev] + cond), so it hoists: embed @ wi + bi (K x 3H) once and
// cond @ wi (rows x frames x 3H) once a call, then a row of each a sample.
// What is left is 2 * (3H*H + H*F + F*K) * 32 FLOPs a sample, 2.5 TFLOP a
// call (37 ms). Every sample depends on the one before: 32,768 steps of a
// (32, H) x (H, 3H) product, a (32, H) x (H, F) and a (32, F) x (F, K), each
// of which needs the whole result of the one before.
//
// Design: the TPU kernel's shape (all rows step together, the weights stay
// resident), as one cooperative launch of one CTA an SM (all resident), in
// three phases a sample separated by split grid barriers (a release/acquire
// counter in device memory; a CTA arrives, does work that does not need the
// others, then waits):
//   prologue  the two input tables, a tiled float32 GEMM over every CTA;
//             each CTA then loads its slices of wh, fc1, fc2 (read from
//             device memory once a call) and of embed @ wi + bi into shared
//             memory, columns transposed so a k step is one float4;
//   A  CTA g owns hidden units [g*nu, (g+1)*nu): the gate update of its
//      units from its table entries and the recurrent gates computed in B,
//      the new units to device memory; arrive, then draw the Gumbel noise
//      of its classes;                                       -- barrier
//   B  every CTA loads the new h whole (L2); CTA g owns fc1 columns
//      [g*nf, ...): ReLU(h @ fc1 + fb1) to device memory; arrive, then the
//      next sample's recurrent gates, the (32, H) x (H, 3*nu) product of h
//      with its wh columns;                                  -- barrier
//   C  CTAs with classes load f1 whole; logits of their nk classes (a
//      multiple of 4, so each Philox quad stays in one CTA), scores, each
//      row's best (value, index) merged across CTAs by one 64-bit atomicMax
//      of an order-preserving key (the larger score, then the lower
//      index);                                               -- barrier
// and the next sample's phase A reads each row's class from the keys (three
// buffers in turn, one reset each sample). Each weight is read from shared
// memory once a sample for all 32 rows. The products (warp_products): warp
// w takes rows 4w .. 4w+3 and its lanes split k, each keeping a register
// tile of 4 rows x 4 or 12 columns, added across the lanes by shuffles in
// a fixed order. No sum depends on timing: the same classes every run for
// a seed. The floor it cannot pass is the latency of three grid barriers a
// sample, 32,768 times.

#include <cuda_runtime.h>

#include "common.cuh"

#define WR_THREADS 256
#define WR_WARPS (WR_THREADS / 32)
#define WR_ROWS 32           // rows a launch (8 row groups x 4)
#define WR_GEMM_TILE 64

struct WaveWeights {
  const float *embed, *wi, *bi, *wh, *bh, *fc1, *fb1, *fc2, *fb2;
};

struct WaveDims {
  int T, hop, C, H, F, K;
};

// The launch's device-memory scratch.
struct WaveScratch {
  float* table;                // (K + R*T, 3H): embed @ wi + bi, then cond @ wi
  float* hg;                   // (R, round_up(H, 4)) the state after phase A, zero pad
  float* fg;                   // (R, round_up(F, 4)) ReLU(fc1) after phase B, zero pad
  unsigned long long* keys;    // (3, R) best (score, index) keys, in turn
  unsigned int* count;         // the split barrier's arrivals, 0 at launch
};

// Each CTA's slices: nu units, nf fc1 columns, nk classes (ceil over the
// grid; nk a multiple of 4) and the padded row strides.
struct WaveSlices {
  int nu, nf, nk;              // units, fc1 columns, classes a CTA
  int na;                      // gate columns (3 * nu) rounded up to a multiple of 4
  int kh, kf;                  // H and F rounded up to a multiple of 128 (a warp's k step)
  int hs, fs;                  // row strides: kh + 4, kf + 4
};

__host__ __device__ inline int wr_round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int wr_max(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline WaveSlices wave_slices(const WaveDims& d, int grid) {
  WaveSlices s;
  s.nu = (d.H + grid - 1) / grid;
  s.nf = (d.F + grid - 1) / grid;
  s.nk = 4 * ((d.K + 4 * grid - 1) / (4 * grid));
  s.na = wr_round_up(3 * s.nu, 4);
  s.kh = wr_round_up(d.H, 128);
  s.kf = wr_round_up(d.F, 128);
  s.hs = s.kh + 4;
  s.fs = s.kf + 4;
  return s;
}

// Floats of a CTA's shared memory (ops/wavernn.py::sample_smem mirrors it).
__host__ __device__ inline size_t wave_smem_floats(const WaveDims& d, const WaveSlices& s) {
  const int na = s.na, nf4 = wr_round_up(s.nf, 4);
  return (size_t)WR_ROWS * s.hs + (size_t)WR_ROWS * s.fs   // h, f1
         + (size_t)na * s.hs + (size_t)nf4 * s.hs + (size_t)s.nk * s.fs  // weight slices
         + (size_t)d.K * na + (size_t)WR_ROWS * na                       // table slices
         + (size_t)WR_ROWS * na                                          // recurrent gates
         + (size_t)WR_ROWS * s.nk                                        // noise, scores
         + na + nf4 + s.nk + WR_ROWS;                                    // biases, classes
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A split grid barrier on one counter (0 at launch): a CTA's n-th arrival
// adds 1 with release semantics after all of its writes; waiting for the
// n-th barrier, one thread polls the counter with acquire semantics until
// all n * gridDim.x arrivals are in. A CTA can work between its arrival and
// its wait. Data written before a barrier is read after it through L2
// (cp.async.cg, __ldcg), not L1. (One flag a CTA, polled by a thread a
// flag, measured slower on an NVIDIA H100 80GB HBM3 at 700 W: 11.5 against
// 7.5 us a sample of three barriers, PERF.md.)
__device__ __forceinline__ void bar_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : "memory");
  }
}

__device__ __forceinline__ void bar_wait(const unsigned int* count, unsigned int n) {
  if (threadIdx.x == 0) {
    const unsigned int target = n * gridDim.x;
    while (ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// 16 bytes global -> shared through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// rows r < R of a device-memory matrix (q float4 a row) into shared memory
// rows of stride dstride floats, all copies in flight at once; ends with a
// block barrier.
__device__ __forceinline__ void load_rows(float* dst, int dstride, const float* src, int q,
                                          int R) {
  for (int e = threadIdx.x; e < R * q; e += WR_THREADS) {
    const int r = e / q, k4 = e - r * q;
    cp_async16(dst + r * dstride + 4 * k4, src + 4 * (size_t)e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The score key: an order-preserving map of the float to 32 bits above the
// complement of the index, so a larger key is the larger score and, on a
// tie, the lower index.
__device__ __forceinline__ unsigned long long score_key(float v, int idx) {
  unsigned int u = __float_as_uint(v + 0.0f);  // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// Warp w sums rows 4w .. 4w+3 of X (stride xs) against columns
// [cb, cb + NC) of W (stride ws) over k < kp (a multiple of 128; X and W are
// zero past the real k). Lane l takes k = 4l + 128m, a float4 a step, so a
// warp's loads of a row are 512 consecutive bytes (no bank conflict, no
// word read twice) and each thread keeps a 4 x NC tile of partial sums in
// registers. The 32 lanes' partial sums of each group of 16 outputs are
// then added by a reduce-scatter of shuffles (four halving steps and a
// final pair) in a fixed order; emit(row, col, sum) is called once for each
// output, by the even lane of the pair that holds it.
template <int NC, class Emit>
__device__ __forceinline__ void warp_products(const float* X, int xs, const float* W, int ws,
                                              int cb, int kp, Emit emit) {
  static_assert((4 * NC) % 16 == 0, "groups of 16 outputs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xr = X + 4 * warp * xs;
  const float* wr = W + cb * ws;
  float acc[4 * NC];  // output i * NC + c: row 4w + i, column cb + c
#pragma unroll
  for (int v = 0; v < 4 * NC; ++v) acc[v] = 0.0f;
  for (int k = 4 * lane; k < kp; k += 128) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(xr + i * xs + k);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(wr + c * ws + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& a = acc[i * NC + c];
        a = fmaf(x[i].x, w.x, a);
        a = fmaf(x[i].y, w.y, a);
        a = fmaf(x[i].z, w.z, a);
        a = fmaf(x[i].w, w.w, a);
      }
    }
  }
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  const int idx = (b4 ? 8 : 0) + (b3 ? 4 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
#pragma unroll
  for (int g0 = 0; g0 < 4 * NC; g0 += 16) {
    float* a = acc + g0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float keep = b4 ? a[8 + j] : a[j], send = b4 ? a[j] : a[8 + j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float keep = b3 ? a[4 + j] : a[j], send = b3 ? a[j] : a[4 + j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float keep = b2 ? a[2 + j] : a[j], send = b2 ? a[j] : a[2 + j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    {
      const float keep = b1 ? a[1] : a[0], send = b1 ? a[0] : a[1];
      a[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
    if (!(lane & 1)) {
      const int v = g0 + idx;
      emit(4 * warp + v / NC, cb + v % NC, a[0]);
    }
  }
}

// The prologue's tables: out[m][n] = A[m] . wi[:, n] (+ bi[n] for m < K),
// rows m < K from embed, the rest from cond; 64 x 64 tiles over the grid,
// a thread 4 x 4 outputs, each an FMA chain over k in ascending order.
__device__ void input_tables(const WaveWeights& w, const WaveDims& d, const float* cond, int R,
                             float* table, float* smem) {
  const int M = d.K + R * d.T, N = 3 * d.H, Kd = d.C;
  float* As = smem;                                 // [16][64 + 4]
  float* Bs = smem + 16 * (WR_GEMM_TILE + 4);       // [16][64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int mt = (M + WR_GEMM_TILE - 1) / WR_GEMM_TILE, nt = (N + WR_GEMM_TILE - 1) / WR_GEMM_TILE;
  for (int tile = blockIdx.x; tile < mt * nt; tile += gridDim.x) {
    const int m0 = (tile / nt) * WR_GEMM_TILE, n0 = (tile % nt) * WR_GEMM_TILE;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < Kd; k0 += 16) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int e = threadIdx.x + WR_THREADS * l;
        const int m = m0 + e / 16, k = k0 + e % 16;
        float a = 0.0f;
        if (m < M && k < Kd)
          a = m < d.K ? __ldg(w.embed + (size_t)m * Kd + k)
                      : __ldg(cond + (size_t)(m - d.K) * Kd + k);
        As[(e % 16) * (WR_GEMM_TILE + 4) + e / 16] = a;
        const int kb = k0 + e / WR_GEMM_TILE, n = n0 + e % WR_GEMM_TILE;
        Bs[e] = (kb < Kd && n < N) ? __ldg(w.wi + (size_t)kb * N + n) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * (WR_GEMM_TILE + 4) + 4 * ty);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[kk * WR_GEMM_TILE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) table[(size_t)m * N + n] = m < d.K ? acc[i][j] + __ldg(w.bi + n) : acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(WR_THREADS, 1)
wavernn_sample_kernel(const float* __restrict__ cond,   // (R, T, C)
                      WaveWeights w, WaveDims d, WaveScratch sc,
                      int* __restrict__ classes,         // (R, T * hop), row stride cstride
                      int R, int row0, int cstride, unsigned long long seed,
                      float temperature, int greedy) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const WaveSlices sl = wave_slices(d, G);
  const int H = d.H, F = d.F, K = d.K, N3 = 3 * H, na = sl.na;
  const int u0 = g * sl.nu, cu = max(0, min(sl.nu, H - u0));
  const int f0 = g * sl.nf, cf = max(0, min(sl.nf, F - f0));
  const int q0 = g * sl.nk, ck = max(0, min(sl.nk, K - q0));
  const int S = d.T * d.hop;
  const int hq = wr_round_up(H, 4) / 4, fq = wr_round_up(F, 4) / 4;  // float4s a row of hg, fg
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);

  // prologue: the input tables over the whole grid (barrier 1)
  input_tables(w, d, cond, R, sc.table, smem);
  bar_arrive(sc.count);
  bar_wait(sc.count, 1);

  float* hs = smem;                                  // [32][hs] the state
  float* fs = hs + WR_ROWS * sl.hs;                  // [32][fs] ReLU(fc1)
  float* WA = fs + WR_ROWS * sl.fs;                  // [3 * nu][hs] wh columns (gate, unit)
  float* W1 = WA + na * sl.hs;                       // [nf][hs] fc1 columns
  float* W2 = W1 + wr_round_up(sl.nf, 4) * sl.hs;    // [nk][fs] fc2 columns
  float* Es = W2 + sl.nk * sl.fs;                    // [K][3 * nu] embed @ wi + bi
  float* cxs = Es + K * na;                          // [32][3 * nu] cond @ wi, this frame
  float* ghs = cxs + WR_ROWS * na;                   // [32][3 * nu] h @ wh + bh
  float* scores = ghs + WR_ROWS * na;                // [32][nk] noise, then scores
  float* bA = scores + WR_ROWS * sl.nk;              // [3 * nu]
  float* b1 = bA + na;                               // [nf]
  float* b2 = b1 + wr_round_up(sl.nf, 4);            // [nk]
  int* prev = reinterpret_cast<int*>(b2 + sl.nk);    // [32]

  // the CTA's slices, zero past the real units, columns, classes and k
  for (int e = tid; e < WR_ROWS * (sl.hs + sl.fs); e += WR_THREADS) hs[e] = 0.0f;
  for (int e = tid; e < na * sl.hs; e += WR_THREADS) {
    const int col = e / sl.hs, k = e % sl.hs, gate = col / sl.nu, j = col % sl.nu;
    WA[e] = (gate < 3 && j < cu && k < H)
                ? __ldg(w.wh + (size_t)k * N3 + gate * H + u0 + j) : 0.0f;
  }
  for (int e = tid; e < wr_round_up(sl.nf, 4) * sl.hs; e += WR_THREADS) {
    const int col = e / sl.hs, k = e % sl.hs;
    W1[e] = (col < cf && k < H) ? __ldg(w.fc1 + (size_t)k * F + f0 + col) : 0.0f;
  }
  for (int e = tid; e < sl.nk * sl.fs; e += WR_THREADS) {
    const int col = e / sl.fs, k = e % sl.fs;
    W2[e] = (col < ck && k < F) ? __ldg(w.fc2 + (size_t)k * K + q0 + col) : 0.0f;
  }
  for (int e = tid; e < K * na; e += WR_THREADS) {
    const int c = e / na, col = e % na, gate = col / sl.nu, j = col % sl.nu;
    Es[e] = (gate < 3 && j < cu) ? __ldcg(sc.table + (size_t)c * N3 + gate * H + u0 + j) : 0.0f;
  }
  for (int e = tid; e < na; e += WR_THREADS) {
    const int gate = e / sl.nu, j = e % sl.nu;
    bA[e] = (gate < 3 && j < cu) ? __ldg(w.bh + gate * H + u0 + j) : 0.0f;
  }
  for (int e = tid; e < wr_round_up(sl.nf, 4); e += WR_THREADS)
    b1[e] = e < cf ? __ldg(w.fb1 + f0 + e) : 0.0f;
  for (int e = tid; e < sl.nk; e += WR_THREADS) b2[e] = e < ck ? __ldg(w.fb2 + q0 + e) : 0.0f;
  __syncthreads();

  // ghs = hs @ WA + bA for every row: the recurrent gates of the next sample
  auto recurrent_gates = [&]() {
    if (cu == 0) return;
    auto emit = [&](int r, int col, float v) { ghs[r * na + col] = v + bA[col]; };
    if (na % 12 == 0) {
      for (int cb = 0; cb < na; cb += 12)
        warp_products<12>(hs, sl.hs, WA, sl.hs, cb, sl.kh, emit);
    } else {
      for (int cb = 0; cb < na; cb += 4) warp_products<4>(hs, sl.hs, WA, sl.hs, cb, sl.kh, emit);
    }
  };
  recurrent_gates();  // h = 0 before sample 0
  // sample s arrives at barriers 3s + 2 (A -> B), 3s + 3 (B -> C), 3s + 4
  // (C -> the next A)
  for (int s = 0; s < S; ++s) {
    const unsigned int nb = 3u * s + 2u;
    // ---- phase A: the classes of sample s - 1, the gates of sample s
    if (s > 0) bar_wait(sc.count, nb - 1);
    if (tid < WR_ROWS) {
      int c = K / 2;
      if (s > 0 && tid < R) {
        c = key_index(__ldcg(sc.keys + ((s - 1) % 3) * WR_ROWS + tid));
        if (g == 0) classes[(size_t)tid * cstride + s - 1] = c;
      }
      prev[tid] = c;
    }
    if (s % d.hop == 0) {
      const int frame = s / d.hop;
      for (int e = tid; e < WR_ROWS * na; e += WR_THREADS) {
        const int r = e / na, col = e % na, gate = col / sl.nu, j = col % sl.nu;
        cxs[e] = (r < R && j < cu)
                     ? __ldcg(sc.table + (size_t)(K + r * d.T + frame) * N3 + gate * H + u0 + j)
                     : 0.0f;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * cu; e += WR_THREADS) {
      const int r = e / cu, j = e % cu;
      const float* ex = Es + prev[r] * na;
      const float* cx = cxs + r * na;
      const float* gh = ghs + r * na;
      const int cz = j, cr = sl.nu + j, cn = 2 * sl.nu + j;
      sc.hg[(size_t)r * 4 * hq + u0 + j] =
          gru_update(ex[cz] + cx[cz], ex[cr] + cx[cr], ex[cn] + cx[cn], gh[cz], gh[cr], gh[cn],
                     hs[r * sl.hs + u0 + j]);
    }
    bar_arrive(sc.count);
    // while the others finish: this CTA's Gumbel noise for sample s
    if (!greedy) {
      for (int e = tid; e < R * ck; e += WR_THREADS) {
        const int r = e / ck, col = e % ck, cls = q0 + col;
        const Philox4 p = philox4x32_10((uint32_t)(cls >> 2), (uint32_t)s, 2u,
                                        (uint32_t)(row0 + r), k0, k1);
        scores[r * sl.nk + col] = -logf(-logf(uniform_open01(p.v[cls & 3])));
      }
    }
    bar_wait(sc.count, nb);

    // ---- phase B: the whole new state; fc1
    if (g == 0 && tid < R) sc.keys[((s + 2) % 3) * WR_ROWS + tid] = 0ull;
    load_rows(hs, sl.hs, sc.hg, hq, R);
    if (cf > 0) {
      auto emit = [&](int r, int col, float v) {
        if (r < R && col < cf) sc.fg[(size_t)r * 4 * fq + f0 + col] = fmaxf(v + b1[col], 0.0f);
      };
      for (int cb = 0; cb < sl.nf; cb += 4) warp_products<4>(hs, sl.hs, W1, sl.hs, cb, sl.kh, emit);
    }
    bar_arrive(sc.count);
    // while the others finish: the next sample's recurrent gates
    recurrent_gates();
    bar_wait(sc.count, nb + 1);

    // ---- phase C: logits of this CTA's classes, each row's best
    if (ck > 0) {
      load_rows(fs, sl.fs, sc.fg, fq, R);
      auto emit = [&](int r, int col, float v) {
        if (r < R && col < ck) {
          const float lg = v + b2[col];
          scores[r * sl.nk + col] = greedy ? lg : lg / temperature + scores[r * sl.nk + col];
        }
      };
      for (int cb = 0; cb < sl.nk; cb += 4) warp_products<4>(fs, sl.fs, W2, sl.fs, cb, sl.kf, emit);
      __syncthreads();
      if (tid < R) {
        float bv = scores[tid * sl.nk];
        int bi = 0;
        for (int col = 1; col < ck; ++col) {
          const float v = scores[tid * sl.nk + col];
          if (v > bv) {
            bv = v;
            bi = col;
          }
        }
        atomicMax(sc.keys + (s % 3) * WR_ROWS + tid, score_key(bv, q0 + bi));
      }
    }
    bar_arrive(sc.count);
  }
  if (S > 0) bar_wait(sc.count, 3u * S + 1u);
  if (g == 0 && tid < R && S > 0)
    classes[(size_t)tid * cstride + S - 1] =
        key_index(__ldcg(sc.keys + ((S - 1) % 3) * WR_ROWS + tid));
}

// One launch for R <= 32 rows (cond (R, T, C), classes (R, T*hop) with row
// stride cstride, row0 the rows' first index for the noise), on `grid`
// CTAs, each resident (a cooperative launch). The scratch: table
// (K + R*T) * 3H floats, hg R * round_up(H, 4) and fg R * round_up(F, 4)
// (zero), keys 3 * 32 (zero), count (zero).
extern "C" int wavernn_sample_launch(const float* cond,
                                     const float* const* weights,  // host array, WaveWeights order
                                     const int* dims,              // host array, WaveDims order
                                     float* table, float* hg, float* fg,
                                     unsigned long long* keys, unsigned int* count,
                                     int* classes, int R, int row0, int cstride, int grid,
                                     unsigned long long seed, float temperature, int greedy,
                                     cudaStream_t stream) {
  WaveWeights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < (int)(sizeof(WaveWeights) / sizeof(const float*)); ++i) wp[i] = weights[i];
  WaveDims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(WaveDims) / sizeof(int)); ++i) dp[i] = dims[i];
  if (R < 1 || R > WR_ROWS || grid < 1 || d.T < 1 || d.hop < 1 || d.K < 1 || d.H < 1 ||
      d.F < 1 || d.C < 1)
    return (int)cudaErrorInvalidValue;
  const WaveSlices sl = wave_slices(d, grid);
  const size_t floats = wave_smem_floats(d, sl);
  const size_t gemm_floats = 16 * (2 * WR_GEMM_TILE + 4);
  const size_t smem = sizeof(float) * (floats > gemm_floats ? floats : gemm_floats);
  cudaError_t err = cudaFuncSetAttribute(
      wavernn_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  WaveScratch sc{table, hg, fg, keys, count};
  void* args[] = {(void*)&cond, &w, &d, &sc, &classes, &R, &row0, &cstride, &seed,
                  &temperature, &greedy};
  err = cudaLaunchCooperativeKernel((void*)wavernn_sample_kernel, dim3(grid), dim3(WR_THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
