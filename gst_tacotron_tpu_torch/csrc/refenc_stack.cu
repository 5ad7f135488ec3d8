// K2 — the GST reference-encoder conv stack: n x (3x3 stride-2 TF-SAME conv,
// folded inference BatchNorm, ReLU) over a (B, T, F) mel, for any T.
//
// Replaces: gst_tacotron_tpu/ops/refenc_pallas.py::refenc_stack_pallas_batched
//           (kernel _refenc_batched_kernel, T % 2^n == 0) and
//           ::refenc_stack_pallas (kernels _refenc_kernel, _conv_bn_relu,
//           _conv_bn_relu_l0, any T). This one kernel serves both contracts.
//
// Semantics: the length mask zeroes mel rows t >= length before layer 0.
// TF "SAME" for k=3, stride 2: out = ceil(in / 2), total pad
// max(0, 2*(out-1) + 3 - in), of which floor(pad/2) goes on top/left (so an
// even input pads one row at the bottom only, an odd one one row each side).
// Kernel layout (3, 3, C_in, C_out); activations (h, w, c) with c fastest, so
// the last layer writes the (B, T', F'*C) output directly.
//
// Bound on the H100 at the main-path shape ((32, 128, 80), channels 32, 32,
// 64, 64, 128, 128): about 0.8 GFLOP (L1 377 MFLOP, L0 47, L2 189, L3 94,
// L4 57, L5 38) against 1.3 MB of input, so the float32 pipe bounds it
// (about 0.012 ms at 67 TFLOP/s); each layer depends on the whole previous
// one.
//
// Design: one launch a layer, each spread over the whole card. A block of
// 256 threads owns a tile of (utterance, pixels, 32 output channels). It
// first copies the input rows its pixels touch and (C_in <= 64) its taps
// into shared memory with cp.async, every copy in flight at once. Lane l
// is output channel l of the tile, the 8 warps are (pixel slot, k part)
// groups, and each thread sums PX pixels of its channel in registers, so a
// weight it loads serves PX outputs and a warp's activation loads are
// broadcasts (16 bytes a lane: 4 input channels at once where
// C_in % 4 == 0). The late layers have few pixels, so their input-channel
// sums are split into ks parts over the warps, whose partial sums are added
// in a fixed order through shared memory. ops/refenc.py::layer_plan picks
// (ks, PX) a layer so that the grid gives every SM two blocks where it can
// (at the main shape 2560, 640, 320, 320, 384 and 512 blocks). A layer's
// output goes to a ping-pong scratch in device memory (L2-resident: at most
// 10.5 MB). float32 FMAs throughout (TF32 products would not hold the JAX
// contract of 1e-5), each sum in a fixed order: the same bits every run.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, each layer takes 20-49 us
// whatever its FLOPs: a layer is latency-bound (PERF.md); a persistent
// launch with a grid barrier between layers is the alternative.
//
// bf16 mode (bf16 = 1): the batched Pallas kernel's bf16 operand mode on
// the tensor cores, one clustered launch for the stack where it fits
// (refenc_bf16.cuh, which describes its design and bound).

#include "common.cuh"
#include "refenc_bf16.cuh"

#define REFENC_MAX_LAYERS 8
#define RE_THREADS 256
#define RE_TC 32   // output channels a block (a warp's lanes)
#define RE_GROUPS (RE_THREADS / 32)

// Copy N (4 or 16) bytes global -> shared without a register, or write N
// zero bytes when !in (the source is then not read).
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int src_size = in ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_size) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(src_size) : "memory");
}

struct RefencLayer {
  const float* in;   // (B, hi, wi, ci)
  float* out;        // (B, ho, wo, co)
  const float* K;    // (3, 3, ci, co), then scale (co), bias (co)
  int hi, wi, ci, ho, wo, co, top, left, first, ks;
};

// The input rows a block of `span` consecutive pixels can touch: its
// output rows i0..i1 read input rows 2*i0 - top .. 2*i1 + 2 - top.
__host__ __device__ inline int refenc_patch_rows(int span, int wo) {
  return 2 * ((span - 1 + wo - 1) / wo) + 3;
}

// Grid (pixel tiles, channel tiles, B); the tile's pixels are the flat
// output positions p = i * wo + q of one utterance. The block first copies,
// with every load in flight, the input rows its pixels touch (rows past the
// length or outside the input as zeros) and, where SW, its channel tile's
// taps [9 * ci][32] into shared memory; then each thread sums from there.
template <int VEC, int PX, bool SW>
__global__ void __launch_bounds__(RE_THREADS)
refenc_layer_kernel(RefencLayer L, const int* __restrict__ lengths) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int ks = L.ks, kpart = g % ks, slot = g / ks, slots = RE_GROUPS / ks;
  const int o0 = blockIdx.y * RE_TC, o = o0 + lane;
  const bool ook = o < L.co;
  const int b = blockIdx.z;
  const int co = L.co, ci = L.ci, wi = L.wi;
  const int npix = L.ho * L.wo;
  const int pb0 = blockIdx.x * slots * PX;
  const int pbase = pb0 + slot * PX;
  const int cper = ((ci + ks - 1) / ks + VEC - 1) / VEC * VEC;
  const int c0 = min(ci, kpart * cper), c1 = min(ci, c0 + cper);
  const int row_lim = L.first && lengths ? min(L.hi, lengths[b]) : L.hi;
  const float* __restrict__ x_b = L.in + (size_t)b * L.hi * wi * ci;

  const int ua = 2 * (pb0 / L.wo) - L.top;              // the patch's first input row
  const int nrows = refenc_patch_rows(slots * PX, L.wo);
  const int rowlen = wi * ci;
  float* Xs = reinterpret_cast<float*>(smem4);           // [nrows][wi][ci]
  float* Ws = Xs + (nrows * rowlen + 3) / 4 * 4;         // [9 * ci][32] (SW)
  float* red = Ws + (SW ? 9 * ci * RE_TC : 0);           // [8][PX][32]
  // cp.async copies (a zero fill where the source size is 0): every copy of
  // the block in flight at once, none waiting on a register
  if (VEC == 4) {
    const int q = rowlen / 4;
    for (int e = threadIdx.x; e < nrows * q; e += RE_THREADS) {
      const int r = e / q, u = ua + r;
      const bool in = u >= 0 && u < row_lim;
      cp_async_zfill<16>(Xs + 4 * e, x_b + (in ? (size_t)u * rowlen + 4 * (e - r * q) : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * rowlen; e += RE_THREADS) {
      const int r = e / rowlen, u = ua + r;
      const bool in = u >= 0 && u < row_lim;
      cp_async_zfill<4>(Xs + e, x_b + (in ? (size_t)u * rowlen + (e - r * rowlen) : 0), in);
    }
  }
  if (SW) {
    for (int e = threadIdx.x; e < 9 * ci * RE_TC; e += RE_THREADS) {
      const int tc = e / RE_TC, l = e % RE_TC;
      const bool in = o0 + l < co;
      cp_async_zfill<4>(Ws + e, L.K + (in ? (size_t)tc * co + o0 + l : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float acc[PX];
  int pi[PX], pq[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    acc[i] = 0.0f;
    const int p = pbase + i;
    pi[i] = p < npix ? p / L.wo : -1;  // -1: an out-of-range pixel reads nothing
    pq[i] = p < npix ? p % L.wo : 0;
  }
  for (int di = 0; di < 3; ++di)
    for (int dj = 0; dj < 3; ++dj) {
      const float* xp[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int r = 2 * pi[i] + di - L.top - ua, v = 2 * pq[i] + dj - L.left;
        xp[i] = (pi[i] >= 0 && v >= 0 && v < wi) ? Xs + (r * wi + v) * ci : nullptr;
      }
      const int tc = (di * 3 + dj) * ci;
      const float* __restrict__ kp = L.K + (size_t)tc * co + (ook ? o : 0);
      const float* ws = Ws + tc * RE_TC + lane;
      if (VEC == 4) {
        for (int c = c0; c < c1; c += 4) {
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = SW ? ws[(c + j) * RE_TC] : (ook ? __ldg(kp + (size_t)(c + j) * co) : 0.0f);
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            if (xp[i] == nullptr) continue;
            const float4 x = *reinterpret_cast<const float4*>(xp[i] + c);
            acc[i] = fmaf(x.x, w[0], acc[i]);
            acc[i] = fmaf(x.y, w[1], acc[i]);
            acc[i] = fmaf(x.z, w[2], acc[i]);
            acc[i] = fmaf(x.w, w[3], acc[i]);
          }
        }
      } else {
        for (int c = c0; c < c1; ++c) {
          const float w = SW ? ws[c * RE_TC] : (ook ? __ldg(kp + (size_t)c * co) : 0.0f);
#pragma unroll
          for (int i = 0; i < PX; ++i)
            if (xp[i] != nullptr) acc[i] = fmaf(xp[i][c], w, acc[i]);
        }
      }
    }

  if (ks > 1) {
#pragma unroll
    for (int i = 0; i < PX; ++i) red[(g * PX + i) * RE_TC + lane] = acc[i];
    __syncthreads();
    if (kpart != 0) return;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      float v = 0.0f;
      for (int k = 0; k < ks; ++k) v += red[((slot * ks + k) * PX + i) * RE_TC + lane];
      acc[i] = v;
    }
  }
  if (!ook) return;
  const float* scale = L.K + 9 * ci * co;
  const float* bias = scale + co;
  const float sc = scale[o], bi = bias[o];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int p = pbase + i;
    if (p < npix) L.out[((size_t)b * npix + p) * co + o] = fmaxf(fmaf(acc[i], sc, bi), 0.0f);
  }
}

// Taps staged in shared memory while the tile's [9 * ci][32] floats fit
// this many bytes (C_in <= 64); past it they are read through the cache
// (staging L5's 147 KB a block measured no faster on an NVIDIA H100 80GB
// HBM3 at 700 W).
#define RE_STAGE_W_BYTES (80 * 1024)

template <int VEC, bool SW>
static cudaError_t launch_layer_sw(const RefencLayer& L, const int* lengths, int px, int B,
                                   cudaStream_t stream) {
  const int slots = RE_GROUPS / L.ks;
  dim3 grid((L.ho * L.wo + slots * px - 1) / (slots * px), (L.co + RE_TC - 1) / RE_TC, B);
  const size_t xs = ((size_t)refenc_patch_rows(slots * px, L.wo) * L.wi * L.ci + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (xs + (SW ? 9 * L.ci * RE_TC : 0) + RE_GROUPS * px * RE_TC);
  cudaError_t err;
  switch (px) {
#define RE_CASE(P)                                                                              \
  case P:                                                                                       \
    err = cudaFuncSetAttribute(refenc_layer_kernel<VEC, P, SW>,                                  \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
    if (err != cudaSuccess) return err;                                                         \
    refenc_layer_kernel<VEC, P, SW><<<grid, RE_THREADS, smem, stream>>>(L, lengths);            \
    break;
    RE_CASE(1)
    RE_CASE(2)
    RE_CASE(4)
#undef RE_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int VEC>
static cudaError_t launch_layer(const RefencLayer& L, const int* lengths, int px, int B,
                                cudaStream_t stream) {
  return 9 * L.ci * RE_TC * sizeof(float) <= RE_STAGE_W_BYTES
             ? launch_layer_sw<VEC, true>(L, lengths, px, B, stream)
             : launch_layer_sw<VEC, false>(L, lengths, px, B, stream);
}

// The bf16 mode's launches (ops/refenc.py::bf16_plan, host ints): the
// count, then per launch l0, l1, bands, smem, stage_off, part_off0,
// part_off1, red_off, then per layer its band rows and k parts. taps: the
// B fragments of layers 1.. in order; scratch: two bf16 activations of the
// leading launches' outputs.
static cudaError_t refenc_bf16_launch(const float* mel, const int* lengths, const float* params,
                                      const int* channels, int n_layers, const int* plan,
                                      const int* taps, float* out, float* scratch, int B, int T,
                                      int F, cudaStream_t stream) {
  RbLaunch P = {};
  P.n = n_layers;
  P.mel = mel;
  P.lengths = lengths;
  P.out = out;
  const int* lay = plan + 1 + 8 * plan[0];
  const float* K = params;
  const uint2* tp = reinterpret_cast<const uint2*>(taps);
  int hi = T, wi = F, ci = 1;
  long long act = 0;  // one scratch activation's bf16 elements
  for (int l = 0; l < n_layers; ++l) {
    RbLayer& Y = P.L[l];
    const int co = channels[l];
    if (co < 1) return cudaErrorInvalidValue;
    Y.hi = hi;
    Y.wi = wi;
    Y.cip = (ci + 15) / 16 * 16;
    Y.ho = (hi + 1) / 2;
    Y.wo = (wi + 1) / 2;
    Y.co = co;
    Y.cop = (co + 15) / 16 * 16;
    Y.top = max(0, 2 * (Y.ho - 1) + 3 - hi) / 2;
    Y.left = max(0, 2 * (Y.wo - 1) + 3 - wi) / 2;
    Y.bh = lay[2 * l];
    Y.ks = lay[2 * l + 1];
    if (Y.bh < 1 || Y.ks < 1) return cudaErrorInvalidValue;
    Y.k0 = K;
    Y.scale = K + 9LL * ci * co;
    Y.bias = Y.scale + co;
    Y.taps = l > 0 ? tp : nullptr;
    if (l > 0) tp += (size_t)(Y.cop / 8) * (9 * Y.cip / 16) * 32;
    const long long a = (long long)B * Y.ho * Y.wo * Y.cop;
    if (l < n_layers - 1 && a > act) act = a;
    K += 9LL * ci * co + 2LL * co;
    hi = Y.ho;
    wi = Y.wo;
    ci = co;
  }
  __nv_bfloat16* acts = reinterpret_cast<__nv_bfloat16*>(scratch);
  for (int k = 0; k < plan[0]; ++k) {
    const int* q = plan + 1 + 8 * k;
    P.l0 = q[0];
    P.l1 = q[1];
    if (P.l0 < 0 || P.l1 <= P.l0 || P.l1 > n_layers || q[2] < 1 || q[2] > 65535 ||
        (P.l1 - P.l0 > 1 && q[2] > 8))
      return cudaErrorInvalidValue;
    P.act_in = P.l0 > 0 ? acts + (size_t)((k - 1) & 1) * act : nullptr;
    P.act_out = P.l1 < n_layers ? acts + (size_t)(k & 1) * act : nullptr;
    P.stage_off = q[4];
    P.part_off0 = q[5];
    P.part_off1 = q[6];
    P.red_off = q[7];
    const cudaError_t err = launch_refenc_bf16(P, q[2], B, q[3], stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// float32: channels, ks and px host arrays of n_layers entries
// (ops/refenc.py::layer_plan); scratch holds 2 * B * max_act floats
// (max_act the largest activation but the last); params each layer's
// kernel, scale and bias. bf16 = 1: the bf16 mode (refenc_bf16_launch:
// plan, taps; ks and px unused).
extern "C" int refenc_stack_launch(const float* mel, const int* lengths, const float* params,
                                   const int* channels, const int* ks, const int* px,
                                   int n_layers, float* out, float* scratch, int B, int T,
                                   int F, int bf16, const int* plan, const int* taps,
                                   cudaStream_t stream) {
  if (n_layers < 1 || n_layers > REFENC_MAX_LAYERS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)refenc_bf16_launch(mel, lengths, params, channels, n_layers, plan, taps, out,
                                   scratch, B, T, F, stream);
  long long max_act = 1;
  {
    int h = T, w = F;
    for (int l = 0; l < n_layers - 1; ++l) {
      h = (h + 1) / 2;
      w = (w + 1) / 2;
      const long long act = (long long)h * w * channels[l];
      if (act > max_act) max_act = act;
    }
  }
  const float* in = mel;
  const float* K = params;
  int hi = T, wi = F, ci = 1;
  for (int l = 0; l < n_layers; ++l) {
    RefencLayer L;
    L.in = in;
    L.out = l == n_layers - 1 ? out : scratch + (size_t)(l & 1) * B * max_act;
    L.K = K;
    L.hi = hi;
    L.wi = wi;
    L.ci = ci;
    L.ho = (hi + 1) / 2;
    L.wo = (wi + 1) / 2;
    L.co = channels[l];
    L.top = max(0, 2 * (L.ho - 1) + 3 - hi) / 2;
    L.left = max(0, 2 * (L.wo - 1) + 3 - wi) / 2;
    L.first = l == 0;
    L.ks = ks[l];
    if (L.ks < 1 || L.ks > RE_GROUPS || RE_GROUPS % L.ks != 0 || L.co < 1)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = ci % 4 == 0 ? launch_layer<4>(L, lengths, px[l], B, stream)
                                        : launch_layer<1>(L, lengths, px[l], B, stream);
    if (err != cudaSuccess) return (int)err;
    K += 9LL * ci * L.co + 2LL * L.co;
    in = L.out;
    hi = L.ho;
    wi = L.wo;
    ci = L.co;
  }
  return (int)cudaSuccess;
}
