// K1 — masked Keras-v2 GRU sequence scan, forward or reverse, or both
// directions of a BiGRU in one call.
//
// Replaces: gst_tacotron_tpu/ops/gru_pallas.py::gru_scan_pallas
//           (kernel body _gru_seq_kernel).
//
// Semantics: gate order z, r, n; reset_after (the reset gate scales the
// recurrent term after its product); h' = z*h + (1-z)*n. A step at or past a
// row's length holds the state and its output row repeats the held state.
// Reverse walks t = T-1 .. 0 with the mask taken at the same t, so a reverse
// scan meets the padded steps first and holds h0 through them.
//
// Bound on the H100 at the main-path shapes (B=32, H=128; encoder T=64 and
// post-net T=400, both directions; reference encoder T=2): the work is
// 2*(D+H)*3H FLOPs a step and row, about 5.9 GFLOP per synthesis against
// ~30 MB of inputs and outputs, so the float32 pipe bounds it (about 0.09 ms
// at 67 TFLOP/s). But the recurrence serialises the T steps of a row: the
// real limit is the latency of one step.
//
// Design: two launches of one call (ndir = 1 or 2 directions, each with its
// own weights; a BiGRU's backward direction writes columns H..2H of ys):
// 1. gru_input_gemm: gx = xs @ wi + bi for every step, row and direction at
//    once, a tiled float32 GEMM over the whole card ((B*T, D) x (D, 3H) a
//    direction, 128 x 64 output tiles, 8 x 4 a thread, the next k-tile
//    loaded while the current one multiplies) into the wrapper's scratch.
//    It does not depend on h, so it needs no serial order.
// 2. gru_recur_kernel on thread-block clusters, one set of clusters a
//    direction, all in one launch: a cluster of C CTAs serves GRU_ROWS batch
//    rows. CTA c owns hidden units [c*Hc, (c+1)*Hc) and keeps their z, r, n
//    columns of wh in registers: thread (unit, slice) holds the KS
//    recurrent weights of its slice of the length-H dot product for each
//    gate, so no FMA chain is longer than KS, and the S slices of a unit (consecutive
//    lanes of one warp) finish the sums with a reduce-scatter of shuffles
//    that leaves each lane one row. Every CTA holds the whole state h
//    (GRU_ROWS x H) in shared memory, double-buffered. After the gate update
//    the lanes of a row push its unit's new value into every CTA of the
//    cluster with st.async, which counts the bytes on the receiver's
//    mbarrier: a CTA waits only until its next state has arrived, with no
//    cluster-wide barrier in the loop. The split is by output unit, not by
//    the reduction axis: no sum crosses CTAs, and the result has the same
//    bits every run (and each direction the bits of its own one-direction
//    call). The input term of the next step is prefetched into registers
//    while the current step computes.
//    KS = 8 weights a lane a gate serve H <= 128 (16 lanes a unit, 256
//    threads); KS = 16 serve H <= 256 (512 threads), with the same exchange.
// 3. Past H = 256 the registers cannot hold a CTA's share of wh, so
//    gru_stream_kernel reads its columns from L2 every step: the same
//    clusters and st.async exchange of the state, which each CTA keeps whole
//    in shared memory for `rows` (4, 2 or 1) batch rows; a CTA's units go to
//    lanes in groups of 32 (coalesced weight rows, the state a broadcast),
//    the length-H sums are split into k parts over the warps and their
//    partial sums added in a fixed order. ops/gru.py::launch_plan picks the
//    form.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GEMM_BM 128
#define GEMM_BN 64
#define GEMM_BK 16
#define GRU_ROWS 4    // batch rows a cluster of the register form
#define GRU_STREAM_THREADS 256

// C (M, N) = A (M, K) @ W (K, N) + bias (N,), row-major, any M, N, K, for
// the direction blockIdx.z (W0, bias0, C0 or W1, bias1, C1). A
// block computes a GEMM_BM x GEMM_BN tile, a thread 8 rows x 4 columns,
// each output one FMA chain over k in ascending order. The next k-tile is
// loaded into registers while the current one is multiplied.
__global__ void __launch_bounds__(256, 2)
gru_input_gemm(const float* __restrict__ A, const float* __restrict__ W0,
               const float* __restrict__ W1, const float* __restrict__ bias0,
               const float* __restrict__ bias1, float* __restrict__ C0, float* __restrict__ C1,
               int M, int N, int K) {
  // direction blockIdx.z: its weights, bias and output
  const float* __restrict__ W = blockIdx.z ? W1 : W0;
  const float* __restrict__ bias = blockIdx.z ? bias1 : bias0;
  float* __restrict__ C = blockIdx.z ? C1 : C0;
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];  // padded: fewer bank conflicts
  __shared__ float Ws[GEMM_BK][GEMM_BN];
  constexpr int LA = GEMM_BM * GEMM_BK / 256, LW = GEMM_BK * GEMM_BN / 256;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // columns tx + 16j, rows 8ty + i
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float ra[LA], rw[LW];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + 256 * l, m = m0 + e / GEMM_BK, k = k0 + e % GEMM_BK;
      ra[l] = (m < M && k < K) ? A[(size_t)m * K + k] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int e = tid + 256 * l, k = k0 + e / GEMM_BN, n = n0 + e % GEMM_BN;
      rw[l] = (k < K && n < N) ? W[(size_t)k * N + n] : 0.0f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + 256 * l;
      As[e % GEMM_BK][e / GEMM_BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int e = tid + 256 * l;
      Ws[e / GEMM_BN][e % GEMM_BN] = rw[l];
    }
    __syncthreads();
    if (k0 + GEMM_BK < K) load(k0 + GEMM_BK);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][8 * ty + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory word in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` more of asynchronous stores in this phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Store v to the cluster address `addr` and count its 4 bytes on the
// mbarrier `bar` of the same CTA.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}

// One direction of a call: its input term, weights, outputs and order.
struct GruDir {
  const float* gx;   // (B, T, 3H) xs @ wi + bi
  const float* h0;   // (B, H)
  const float* wh;   // (H, 3H)
  const float* bh;   // (3H,)
  float* ys;         // (B, T, .) with row stride ys_stride
  float* final_h;    // (B, H)
  int reverse;
};

struct GruDirs {
  GruDir d[2];
};

// Grid (C, ndir * clusters) in clusters of (C, 1, 1), blockIdx.y / clusters
// the direction (dirs.d[0] or dirs.d[1]); blockDim.x threads,
// thread tid = unit_local * S + slice (S a power of two, 4 <= S <= 16),
// holding KS recurrent weights a gate. hp = S * KS >= H is the padded row
// length of the shared state. Lane slice sl owns row sl % 4 of the cluster's
// four after the reduction; the S / 4 lanes of a row push its new value to
// C / (S / 4) CTAs each. State buffer b = s & 1 holds h before step s;
// mbarrier b completes when every CTA's pushes of step s - 1 have landed in
// it (4 * H * rows bytes), once every two steps, so step s waits on phase
// parity ((s - 1) / 2) & 1. A CTA pushes step s into buffer (s + 1) & 1 of
// another only after it has every push of step s - 1, each sent after its
// sender's reads of that buffer: no CTA overwrites state another still reads.
template <int KS>
__global__ void __launch_bounds__(32 * KS)
gru_recur_kernel(GruDirs dirs, const int* __restrict__ lengths,  // (B,) or null
                 int B, int T, int H, int hc, int S, int ys_stride, int clusters) {
  static_assert(GRU_ROWS == 4, "the reduce-scatter splits rows on two lane bits");
  // this CTA's direction, field by field (a reference into the parameters
  // would copy them to local memory)
  const bool d1 = blockIdx.y >= clusters;
  const float* __restrict__ gx = d1 ? dirs.d[1].gx : dirs.d[0].gx;
  const float* __restrict__ h0 = d1 ? dirs.d[1].h0 : dirs.d[0].h0;
  const float* __restrict__ wh = d1 ? dirs.d[1].wh : dirs.d[0].wh;
  const float* __restrict__ bh = d1 ? dirs.d[1].bh : dirs.d[0].bh;
  float* __restrict__ ys = d1 ? dirs.d[1].ys : dirs.d[0].ys;
  float* __restrict__ final_h = d1 ? dirs.d[1].final_h : dirs.d[0].final_h;
  const int reverse = d1 ? dirs.d[1].reverse : dirs.d[0].reverse;
  extern __shared__ float4 smem4[];
  const int hp = S * KS;
  float* hbuf = reinterpret_cast<float*>(smem4);                          // [2][GRU_ROWS][hp]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(hbuf + 2 * GRU_ROWS * hp);  // [2]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int ul = tid / S, sl = tid % S;
  const int u = c * hc + ul;
  const bool unit_ok = ul < hc && u < H;
  const int row0 = (blockIdx.y % clusters) * GRU_ROWS;
  const int r = sl & (GRU_ROWS - 1);           // this lane's row
  const int gi = sl / GRU_ROWS, gn = S / GRU_ROWS;  // its place among the row's lanes
  const bool act = unit_ok && row0 + r < B;
  const int G = 3 * H;
  const uint32_t hb = smem_addr(hbuf), mb = smem_addr(mbar);
  const uint32_t tx_bytes = 4u * H * min(GRU_ROWS, B - row0);

  // this thread's recurrent weights: rows sl*KS + i of columns u, H+u, 2H+u
  float w[3][KS];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int k = sl * KS + i;
      w[g][i] = (unit_ok && k < H) ? wh[(size_t)k * G + g * H + u] : 0.0f;
    }
  float bz = 0.0f, br = 0.0f, bn = 0.0f;
  if (unit_ok) {
    bz = bh[u];
    br = bh[H + u];
    bn = bh[2 * H + u];
  }
  const int len = act ? (lengths ? lengths[row0 + r] : T) : 0;
  const float* gxr = gx + ((size_t)(act ? row0 + r : 0) * T) * G + (act ? u : 0);

  if (tid == 0) {
    mbar_init(mb, 1);
    mbar_init(mb + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * GRU_ROWS * hp; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < GRU_ROWS * H; i += blockDim.x) {
    const int rr = i / H, k = i % H;
    if (row0 + rr < B) hbuf[rr * hp + k] = h0[(size_t)(row0 + rr) * H + k];
  }
  // every CTA has started and set its buffers and barriers before any push
  cluster.sync();
  // this lane's word (row r, unit u) of state buffer 0; cluster_addr maps it
  // into every CTA
  const uint32_t hu = hb + 4u * (r * hp + (unit_ok ? u : 0));

  float gxn[3] = {0.0f, 0.0f, 0.0f};
  auto prefetch = [&](int s) {
    if (act && s < T) {
      const float* g = gxr + (size_t)(reverse ? T - 1 - s : s) * G;
      gxn[0] = g[0];
      gxn[1] = g[H];
      gxn[2] = g[2 * H];
    }
  };
  prefetch(0);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int cur = s & 1, nxt = cur ^ 1;
    if (s > 0) mbar_wait(mb + 8 * cur, ((s - 1) >> 1) & 1);
    if (tid == 0) mbar_expect(mb + 8 * nxt, tx_bytes);
    const float* hcur = hbuf + cur * GRU_ROWS * hp;
    const float xz = gxn[0], xr = gxn[1], xn = gxn[2];
    prefetch(s + 1);

    float acc[GRU_ROWS][3];
#pragma unroll
    for (int q = 0; q < GRU_ROWS; ++q) {
      const float4* hv = reinterpret_cast<const float4*>(hcur + q * hp + sl * KS);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int i4 = 0; i4 < KS / 4; ++i4) {
        const float4 x = hv[i4];
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a0 = fmaf(xv[j], w[0][4 * i4 + j], a0);
          a1 = fmaf(xv[j], w[1][4 * i4 + j], a1);
          a2 = fmaf(xv[j], w[2][4 * i4 + j], a2);
        }
      }
      acc[q][0] = a0;
      acc[q][1] = a1;
      acc[q][2] = a2;
    }
    // reduce-scatter over the unit's S consecutive lanes: lane bit 1 keeps
    // rows {2b, 2b+1}, lane bit 0 one of them, so lane sl ends with row
    // sl % 4; then a butterfly over the higher bits (every lane of a row
    // gets the same bits: a + b == b + a)
    const bool b1 = sl & 2, b0 = sl & 1;
    float k2[2][3], v[3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float send = b1 ? acc[h][g] : acc[2 + h][g];
        const float keep = b1 ? acc[2 + h][g] : acc[h][g];
        k2[h][g] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float send = b0 ? k2[0][g] : k2[1][g];
      const float keep = b0 ? k2[1][g] : k2[0][g];
      v[g] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
    for (int off = GRU_ROWS; off < S; off <<= 1) {
#pragma unroll
      for (int g = 0; g < 3; ++g) v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
    }

    const float h = hcur[r * hp + (unit_ok ? u : 0)];
    float hn = gru_update(xz, xr, xn, v[0] + bz, v[1] + br, v[2] + bn, h);
    hn = t < len ? hn : h;
    if (act) {
      if (gi == 0) ys[((size_t)(row0 + r) * T + t) * ys_stride + u] = hn;
      const uint32_t a = hu + 4u * nxt * GRU_ROWS * hp;
      for (int q = gi; q < C; q += gn) push(cluster_addr(a, q), hn, cluster_addr(mb + 8 * nxt, q));
    }
  }

  if (T > 0) mbar_wait(mb + 8 * (T & 1), ((T - 1) >> 1) & 1);
  if (act && gi == 0)
    final_h[(size_t)(row0 + r) * H + u] = hbuf[(T & 1) * GRU_ROWS * hp + r * hp + u];
  // no CTA leaves while another may still address its shared memory
  cluster.sync();
}

// The recurrence past H = 256: grid (C, ndir * clusters) in clusters of
// (C, 1, 1) as above, GRU_STREAM_THREADS threads, `rows` (<= 4) batch rows
// a cluster. CTA c owns units [c*hc, (c+1)*hc). Shared memory: the state
// hbuf[2][rows][H] (double-buffered, filled by st.async pushes counted on
// mbarrier nxt as in gru_recur_kernel), the partial sums
// part[kp][rows][3][hc] and the two mbarriers. Each step the warps take
// work items (unit group of 32 lanes, k part of kl = ceil(H / kp) rows of
// wh): lane l sums, for every row, its unit's three gate columns over the
// part's k in ascending order, reading wh from L2 (a warp's loads of one k
// row are 128 consecutive bytes) and the state as a broadcast; then thread
// (row, unit) adds the kp partial sums in order, updates the state and
// pushes it into every CTA of the cluster.
// Floats of gru_stream_kernel's state and partial sums, rounded up to an
// even count so that the two mbarriers after them are 8-byte aligned
// (ops/gru.py::launch_plan adds their 16 bytes).
__host__ __device__ inline int gru_stream_floats(int H, int hc, int kp, int rows) {
  return (2 * rows * H + kp * rows * 3 * hc + 1) & ~1;
}

__global__ void __launch_bounds__(GRU_STREAM_THREADS)
gru_stream_kernel(GruDirs dirs, const int* __restrict__ lengths,  // (B,) or null
                  int B, int T, int H, int hc, int kp, int rows, int ys_stride,
                  int clusters) {
  const bool d1 = blockIdx.y >= clusters;
  const float* __restrict__ gx = d1 ? dirs.d[1].gx : dirs.d[0].gx;
  const float* __restrict__ h0 = d1 ? dirs.d[1].h0 : dirs.d[0].h0;
  const float* __restrict__ wh = d1 ? dirs.d[1].wh : dirs.d[0].wh;
  const float* __restrict__ bh = d1 ? dirs.d[1].bh : dirs.d[0].bh;
  float* __restrict__ ys = d1 ? dirs.d[1].ys : dirs.d[0].ys;
  float* __restrict__ final_h = d1 ? dirs.d[1].final_h : dirs.d[0].final_h;
  const int reverse = d1 ? dirs.d[1].reverse : dirs.d[0].reverse;
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);                        // [2][rows][H]
  float* part = hbuf + 2 * rows * H;                                    // [kp][rows][3][hc]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(hbuf + gru_stream_floats(H, hc, kp, rows));
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = GRU_STREAM_THREADS / 32;
  const int row0 = (blockIdx.y % clusters) * rows;
  const int nrows = min(rows, B - row0);
  const int G = 3 * H;
  const int ng = (hc + 31) / 32, kl = (H + kp - 1) / kp;
  const uint32_t hb = smem_addr(hbuf), mb = smem_addr(mbar);
  const uint32_t tx_bytes = 4u * H * nrows;

  if (tid == 0) {
    mbar_init(mb, 1);
    mbar_init(mb + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * rows * H; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < nrows * H; i += blockDim.x)
    hbuf[i] = h0[(size_t)row0 * H + i];
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int cur = s & 1, nxt = cur ^ 1;
    if (s > 0) mbar_wait(mb + 8 * cur, ((s - 1) >> 1) & 1);
    if (tid == 0) mbar_expect(mb + 8 * nxt, tx_bytes);
    const float* hcur = hbuf + cur * rows * H;
    for (int item = warp; item < ng * kp; item += nwarps) {
      const int g = item % ng, p = item / ng;
      const int ul = g * 32 + lane, u = c * hc + ul;
      const bool ok = ul < hc && u < H;
      const int k0 = p * kl, k1 = min(H, k0 + kl);
      float acc[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
      if (ok) {
        const float* w = wh + u;
        for (int k = k0; k < k1; ++k) {
          const float wz = __ldg(w + (size_t)k * G), wr = __ldg(w + (size_t)k * G + H),
                      wn = __ldg(w + (size_t)k * G + 2 * H);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < rows) {
              const float x = hcur[q * H + k];
              acc[q][0] = fmaf(x, wz, acc[q][0]);
              acc[q][1] = fmaf(x, wr, acc[q][1]);
              acc[q][2] = fmaf(x, wn, acc[q][2]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < rows)
#pragma unroll
            for (int gg = 0; gg < 3; ++gg) part[((p * rows + q) * 3 + gg) * hc + ul] = acc[q][gg];
      }
    }
    __syncthreads();
    for (int e = tid; e < nrows * hc; e += blockDim.x) {
      const int q = e / hc, ul = e - q * hc, u = c * hc + ul;
      if (u >= H) continue;
      float v[3];
#pragma unroll
      for (int gg = 0; gg < 3; ++gg) {
        float a = 0.0f;
        for (int p = 0; p < kp; ++p) a += part[((p * rows + q) * 3 + gg) * hc + ul];
        v[gg] = a + bh[gg * H + u];
      }
      const int row = row0 + q;
      const float* gxr = gx + ((size_t)row * T + t) * G + u;
      const float h = hcur[q * H + u];
      const int len = lengths ? lengths[row] : T;
      float hn = gru_update(gxr[0], gxr[H], gxr[2 * H], v[0], v[1], v[2], h);
      hn = t < len ? hn : h;
      ys[((size_t)row * T + t) * ys_stride + u] = hn;
      const uint32_t a = hb + 4u * (nxt * rows * H + q * H + u);
      for (int r = 0; r < C; ++r) push(cluster_addr(a, r), hn, cluster_addr(mb + 8 * nxt, r));
    }
  }

  if (T > 0) mbar_wait(mb + 8 * (T & 1), ((T - 1) >> 1) & 1);
  for (int e = tid; e < nrows * hc; e += blockDim.x) {
    const int q = e / hc, u = c * hc + e % hc;
    if (u < H) final_h[(size_t)(row0 + q) * H + u] = hbuf[(T & 1) * rows * H + q * H + u];
  }
  cluster.sync();
}

// One call: the input GEMM of every direction, then the clustered
// recurrence of every direction in one launch. ndir 1: the scan of
// direction 0 (reverse as given), ys (B, T, H). ndir 2: a BiGRU, direction 0
// forward and 1 reverse, ys (B, T, 2H) with the backward states in columns
// H..2H. C CTAs a cluster (C <= 8), hc units a CTA. ks = 8 or 16: the
// register form, S slices of ks weights a unit (4 <= S <= 16), `threads` =
// hc * S rounded up to a warp, GRU_ROWS rows a cluster; ks = 0: the
// streamed form, kp k parts, `rows` rows a cluster, GRU_STREAM_THREADS
// threads. The wrapper's launch plan (ops/gru.py::launch_plan) picks them
// and the shared memory `smem`. gx_scratch holds ndir * B * T * 3H floats.
extern "C" int gru_scan_launch(const float* xs, const int* lengths, int ndir,
                               const float* h0a, const float* h0b, const float* wia,
                               const float* wib, const float* bia, const float* bib,
                               const float* wha, const float* whb, const float* bha,
                               const float* bhb, float* ys, float* fina, float* finb,
                               float* gx_scratch, int B, int T, int D, int H, int reverse,
                               int C, int hc, int ks, int S, int threads, int kp, int rows,
                               int smem, cudaStream_t stream) {
  const bool reg = ks == 8 || ks == 16;
  if (ndir < 1 || ndir > 2 || C < 1 || C > 8 || C * hc < H || rows < 1 || rows > GRU_ROWS ||
      (reg && (S < 4 || S > 16 || (S & (S - 1)) != 0 || threads % 32 != 0 ||
               threads > 32 * ks || threads < hc * S || S * ks < H || rows != GRU_ROWS)) ||
      (!reg && (ks != 0 || kp < 1 || threads != GRU_STREAM_THREADS ||
                smem != 4 * gru_stream_floats(H, hc, kp, rows) + 16)))
    return (int)cudaErrorInvalidValue;
  const int G = 3 * H;
  const long long M = (long long)B * T;
  float* gxa = gx_scratch;
  float* gxb = gx_scratch + (ndir == 2 ? M * G : 0);
  if (M > 0) {
    dim3 grid((G + GEMM_BN - 1) / GEMM_BN, (unsigned)((M + GEMM_BM - 1) / GEMM_BM), ndir);
    gru_input_gemm<<<grid, 256, 0, stream>>>(xs, wia, wib, bia, bib, gxa, gxb, (int)M, G, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int clusters = (B + rows - 1) / rows;
  GruDirs dirs;
  dirs.d[0] = GruDir{gxa, h0a, wha, bha, ys, fina, ndir == 2 ? 0 : reverse};
  dirs.d[1] = GruDir{gxb, h0b, whb, bhb, ys + H, finb, 1};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, ndir * clusters, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (ks == 8) {
    err = cudaLaunchKernelEx(&cfg, gru_recur_kernel<8>, dirs, lengths, B, T, H, hc, S,
                             ndir * H, clusters);
  } else if (ks == 16) {
    err = cudaLaunchKernelEx(&cfg, gru_recur_kernel<16>, dirs, lengths, B, T, H, hc, S,
                             ndir * H, clusters);
  } else {
    err = cudaFuncSetAttribute(gru_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, gru_stream_kernel, dirs, lengths, B, T, H, hc, kp, rows,
                             ndir * H, clusters);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
