// K2's bf16 operand mode on the tensor cores: the batched Pallas kernel's
// refenc_stack_pallas_batched(bf16=True) (_refenc_batched_kernel, weights
// shipped as bf16): each layer's input and its conv taps rounded to
// bfloat16 (round to nearest even), their products summed in float32, the
// folded-BN epilogue and ReLU in float32.
//
// Bound on the H100 at the main-path shape ((32, 128, 80), channels 32, 32,
// 64, 64, 128, 128): about 0.8 GFLOP, 0.8 us at the 989 TFLOP/s of the bf16
// tensor cores, against 1.3 MB of input (0.4 us); each layer depends on the
// whole previous one, so the six layers' latency, not their work, bounds a
// launch a layer (20-49 us each as float32, PERF.md).
//
// Design: one launch for the stack where it fits (the host plan,
// ops/refenc.py::bf16_plan): a thread-block cluster per utterance, CTA c
// of cw owning a band of ceil(h / cw) output rows of every layer (cw = 4
// at the main shape: 128 CTAs for 32 utterances; cw depends on the shape,
// never on the batch, so a row's bits are the same in any batch). A band's
// outputs stay in the CTA's shared memory as bf16 (exact for this mode: the
// next layer rounds its input to bf16 anyway); the last layer writes its
// float32 output. Before each layer a cluster barrier, then each CTA
// stages the 2 * rows + 1 input rows its band reads (its own and a halo
// row of a neighbour, through distributed shared memory), zero-padded by
// one pixel each side, 16 bytes of padding a pixel. Layer 0 (C_in = 1, 6%
// of the FLOPs) runs on the CUDA cores; layers 1+ are implicit GEMMs
// (pixels x 9 * C_in x C_out) on mma.sync.m16n8k16 bf16 -> float32: A
// comes from the staged rows through ldmatrix with one address a lane
// (im2col by address), B from the host's fragment tables (taps rounded to
// bf16 once and cached, ops/refenc.py::_bf16_taps), read through the cache
// four k16 steps ahead of their use. A warp owns 16 pixels x 32 channels;
// where a band has fewer than 8 such units (the late layers) the taps are
// split into k parts over the warps, added in a fixed order through shared
// memory. Channels pad to a multiple of 16 (zero inputs and taps).
// A CTA takes 106 KB of shared memory at the main shape (the k parts'
// partial sums inside the staging region) and at most 128 registers, so
// two share an SM and the 32 clusters of 4 run in one wave. Where an
// utterance's bands do not fit even at cw = 8, the leading layers run
// first, one launch each, over bands of rows (no cluster), with the same
// tile code, reading and writing bf16 activations in device memory. No
// atomics: the same bits every run. The layer's fields are read into
// scalars (a struct captured by a lambda would live on the stack), and the
// k16 steps advance their A address by pointer steps, no division.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define RB_THREADS 256
#define RB_WARPS 8
#define RB_PAD 8          // bf16 of padding a staged pixel (16 bytes)
#define RB_MAX_LAYERS 8

struct RbLayer {
  const uint2* taps;    // layers 1+: mma B fragments (cop / 8, 9 * cip / 16, 32 lanes)
  const float* k0;      // layer 0: the float32 taps (9, co), rounded in the kernel
  const float* scale;
  const float* bias;
  int hi, wi, cip, ho, wo, co, cop, top, left;
  int bh;               // output rows a band
  int ks;               // k parts a (16-pixel, 32-channel) unit
};

struct RbLaunch {
  int l0, l1, n;                      // layers [l0, l1) of n
  const float* mel;                   // l0 == 0: (B, T, F)
  const int* lengths;                 // l0 == 0: rows t >= lengths[b] are zero
  const __nv_bfloat16* act_in;        // l0 > 0: (B, hi, wi, cip)
  float* out;                         // l1 == n: (B, ho, wo * co)
  __nv_bfloat16* act_out;             // l1 < n: (B, ho, wo, cop)
  int stage_off, part_off0, part_off1, red_off;  // red_off: inside the staging region,
  RbLayer L[RB_MAX_LAYERS];                      // past the rows of every k-split layer
};

__device__ __forceinline__ float rb_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void rb_ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Grid (bands, B): CTA (band, b) owns rows [band * bh, band * bh + bh) of
// every layer's output of utterance b; a launch of more than one layer is
// one cluster of `bands` CTAs an utterance.
__global__ void __launch_bounds__(RB_THREADS, 2)
refenc_bf16_kernel(const __grid_constant__ RbLaunch P) {
  extern __shared__ float4 rb_smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(rb_smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int band = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool clustered = P.l1 - P.l0 > 1;

  // the launch's fields in registers: read through a reference, every
  // access after a store would be reloaded from parameter space
  const int l_beg = P.l0, l_end = P.l1, n_layers = P.n;
  float* const out = P.out;
  __nv_bfloat16* const act_out = P.act_out;
  const __nv_bfloat16* const act_in = P.act_in;
  const int stage_off = P.stage_off, red_off = P.red_off;
  const int part_off0 = P.part_off0, part_off1 = P.part_off1;
  for (int l = l_beg; l < l_end; ++l) {
    // the layer's fields as scalars (a struct captured by a lambda would
    // live on the stack)
    const RbLayer& Yp = P.L[l];
    const int hi = Yp.hi, wi = Yp.wi, ho = Yp.ho, wo = Yp.wo, co = Yp.co, cop = Yp.cop;
    const int top = Yp.top, left = Yp.left, bh = Yp.bh;
    const uint2* const taps = Yp.taps;
    const float* const k0 = Yp.k0;
    const float* const scale = Yp.scale;
    const float* const bias = Yp.bias;
    const int i0 = min(ho, band * bh), i1 = min(ho, i0 + bh);
    const int np = (i1 - i0) * wo;       // the band's output pixels
    const int u0 = 2 * i0 - top;         // its first input row
    const int nr = 2 * (i1 - i0) + 1;      // input rows it reads
    const bool first = l == l_beg, last = l == l_end - 1, final_layer = l == n_layers - 1;
    if (!first) cluster.sync();  // the peers' outputs of layer l - 1 are complete
    __nv_bfloat16* part = reinterpret_cast<__nv_bfloat16*>(
        smem + ((l & 1) ? part_off1 : part_off0));
    // output pixel p of the band, channel o (o < cop; y = 0 past co)
    auto store = [=](int p, int o, float y) {
      const int i = i0 + p / wo, q = p - (p / wo) * wo;
      if (final_layer) {
        if (o < co) out[((size_t)b * ho + i) * wo * co + q * co + o] = y;
      } else if (last) {
        act_out[(((size_t)b * ho + i) * wo + q) * cop + o] = __float2bfloat16_rn(y);
      } else {
        part[((size_t)(i - i0) * wo + q) * cop + o] = __float2bfloat16_rn(y);
      }
    };
    auto epilogue = [=](int o, float acc) {
      return o < co ? fmaxf(fmaf(acc, __ldg(scale + o), __ldg(bias + o)), 0.0f) : 0.0f;
    };

    if (l == 0) {
      // ---- layer 0 on the CUDA cores: the band's mel rows, masked and
      // rounded to bf16, staged as float with a zero column each side
      float* stg = reinterpret_cast<float*>(smem + stage_off);
      const int F = wi, ws = F + 2;
      const int lim = P.lengths ? min(hi, P.lengths[b]) : hi;
      const float* x = P.mel + (size_t)b * hi * F;
      if (np > 0) {
        // every copy in flight at once (cp.async, zero fill), then rounded
        for (int e = threadIdx.x; e < nr * ws; e += RB_THREADS) {
          const int r = e / ws, v = e - r * ws - 1, u = u0 + r;
          const bool in = u >= 0 && u < lim && v >= 0 && v < F;
          cp_async4_zfill(stg + e, x + (in ? (size_t)u * F + v : 0), in);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        for (int e = threadIdx.x; e < nr * ws; e += RB_THREADS) stg[e] = rb_round(stg[e]);
      }
      __syncthreads();
      // a thread: a channel quad, its 4 channels' taps, scale and bias in
      // registers, over pixels p0, p0 + step, ...; the 9 taps ascending,
      // float32 FMAs
      const int c4 = cop / 4;
      auto quad = [=](int oq, int p0, int step) {
        const int o = 4 * oq;
        float wr[9][4], sc[4], bs[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = o + j < co;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wr[tap][j] = ok ? rb_round(__ldg(k0 + tap * co + o + j)) : 0.0f;
          sc[j] = ok ? __ldg(scale + o + j) : 0.0f;
          bs[j] = ok ? __ldg(bias + o + j) : 0.0f;
        }
        int i = p0 / wo, q = p0 - i * wo;
        for (int p = p0; p < np; p += step) {
          const float* xp = stg + (2 * i) * ws + 2 * q - left + 1;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const float xv = xp[(tap / 3) * ws + tap % 3];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = fmaf(xv, wr[tap][j], acc[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store(p, o + j, o + j < co ? fmaxf(fmaf(acc[j], sc[j], bs[j]), 0.0f) : 0.0f);
          q += step;
          while (q >= wo) q -= wo, ++i;
        }
      };
      const int per = RB_THREADS / c4;  // threads a channel quad
      if (per > 0) {
        if (threadIdx.x < per * c4) quad(threadIdx.x % c4, threadIdx.x / c4, per);
      } else {
        for (int oq = threadIdx.x; oq < c4; oq += RB_THREADS) quad(oq, 0, 1);
      }
    } else {
      // ---- layers 1+: stage the input rows [u0, u0 + nr), columns -1..wi,
      // cip channels at a pixel stride of cip + RB_PAD, 16 bytes a copy
      __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem + stage_off);
      const int cip = Yp.cip, ps = cip + RB_PAD, ws = wi + 2, c8 = cip / 8;
      const int xbh = P.L[l - 1].bh;  // the band rows of this layer's input
      const __nv_bfloat16* src_part = reinterpret_cast<const __nv_bfloat16*>(
          smem + ((l & 1) ? part_off0 : part_off1));
      const int ne = np > 0 ? nr * ws * c8 : 0;
      for (int e0 = threadIdx.x; e0 < ne; e0 += 8 * RB_THREADS) {
        uint4 val[8];  // 8 loads in flight a thread
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = e0 + j * RB_THREADS;
          const int c = e % c8, pix = e / c8, r = pix / ws, v = pix - r * ws - 1, u = u0 + r;
          val[j] = make_uint4(0, 0, 0, 0);
          if (e < ne && u >= 0 && u < hi && v >= 0 && v < wi) {
            if (first) {
              val[j] = *reinterpret_cast<const uint4*>(
                  act_in + (((size_t)b * hi + u) * wi + v) * cip + 8 * c);
            } else {
              const int owner = u / xbh;  // the CTA whose band holds row u
              const __nv_bfloat16* peer = cluster.map_shared_rank(src_part, owner);
              val[j] = *reinterpret_cast<const uint4*>(
                  peer + ((size_t)(u - owner * xbh) * wi + v) * cip + 8 * c);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = e0 + j * RB_THREADS;
          const int c = e % c8, pix = e / c8, r = pix / ws, v = pix - r * ws;
          if (e < ne) *reinterpret_cast<uint4*>(stg + (size_t)(r * ws + v) * ps + 8 * c) = val[j];
        }
      }
      __syncthreads();

      // units of 16 pixels x 32 channels, each split into ks k parts
      const int KS = 9 * cip / 16, cpt = cip / 16;  // k16 steps, a tap's
      const int mt = (np + 15) / 16, ng = (cop + 31) / 32;
      const int ks = Yp.ks, items = mt * ng * ks;
      float* red = reinterpret_cast<float*>(smem + red_off);  // [item][16][32]
      const int g = lane >> 2, t = lane & 3;
      for (int item = warp; item < items; item += RB_WARPS) {
        const int unit = item / ks, kpart = item - unit * ks;
        const int mtile = unit / ng, grp = unit - mtile * ng;
        const int nt0 = grp * 4, ntl = min(4, cop / 8 - nt0);
        // this lane's A row (pixel mtile * 16 + lane % 16): its tap (0, 0)
        // address, or a zero pixel (staged column -1) past the band
        const int pa = mtile * 16 + (lane & 15);
        const bool valid = pa < np;
        const int ia = valid ? pa / wo : 0, qa = valid ? pa - ia * wo : 0;
        const __nv_bfloat16* abase =
            stg + (size_t)(valid ? (2 * ia * ws + 2 * qa - left + 1) : 0) * ps + (lane >> 4) * 8;
        const int s0 = kpart * KS / ks, s1 = (kpart + 1) * KS / ks;
        // B fragments: n8 tile j's run of k16 steps is KS * 32 uint2 long
        const uint2* tb = taps + ((size_t)nt0 * KS + s0) * 32 + lane;
        const size_t tstride = (size_t)KS * 32;
        auto load_b = [=](int d, uint2 (&q)[4]) {  // step s0 + d
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[j] = j < ntl ? __ldg(tb + j * tstride + d * 32) : make_uint2(0, 0);
        };
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
        uint2 bq[4][4];  // B fragments of the next 4 k16 steps
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (s0 + d < s1) load_b(d, bq[d]);
        // the A address of step s0, then advanced step by step: 16 channels,
        // or the next tap (dj, then di) past the cip / 16 steps of a tap
        int tap = s0 / cpt, c16 = s0 - tap * cpt, dj = tap % 3;
        int off = valid ? ((tap / 3) * ws + dj) * ps : 0;
        const int step_dj = valid ? ps : 0, step_di = valid ? (ws - 2) * ps : 0;
        const __nv_bfloat16* ap = abase + off + 16 * c16;
        for (int s = 0; s < s1 - s0; s += 4) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (s + d < s1 - s0) {
              uint32_t a[4];
              rb_ldmatrix_x4(a, ap);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (j < ntl) mma_bf16_16816(acc[j], a, bq[d][j]);
              if (s + d + 4 < s1 - s0) load_b(s + d + 4, bq[d]);
              if (++c16 < cpt) {
                ap += 16;
              } else {
                c16 = 0;
                off += dj == 2 ? step_di : step_dj;
                dj = dj == 2 ? 0 : dj + 1;
                ap = abase + off;
              }
            }
          }
        }
        // fragment i of n8 tile j: pixel mtile * 16 + g + 8 * (i / 2),
        // channel (nt0 + j) * 8 + 2t + i % 2
        if (ks == 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int p = mtile * 16 + g + 8 * (i / 2), o = (nt0 + j) * 8 + 2 * t + i % 2;
              if (j < ntl && p < np) store(p, o, epilogue(o, acc[j][i]));
            }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              red[(item * 16 + g + 8 * (i / 2)) * 32 + j * 8 + 2 * t + i % 2] = acc[j][i];
        }
      }
      if (ks > 1) {
        __syncthreads();
        // each unit's k parts added in order 0..ks-1, then the epilogue
        for (int e = threadIdx.x; e < mt * ng * 16 * 32; e += RB_THREADS) {
          const int unit = e / 512, rc = e - unit * 512, row = rc / 32, col = rc - row * 32;
          const int mtile = unit / ng, grp = unit - mtile * ng;
          const int p = mtile * 16 + row, o = grp * 32 + col;
          if (p >= np || o >= cop) continue;
          float v = 0.0f;
          for (int k = 0; k < ks; ++k) v += red[((unit * ks + k) * 16 + row) * 32 + col];
          store(p, o, epilogue(o, v));
        }
      }
    }
    __syncthreads();  // the staging buffer is reused by the next layer
  }
  if (clustered) cluster.sync();  // no CTA leaves while a peer may read its outputs
}

// One launch of layers [l0, l1): `bands` CTAs an utterance, in one cluster
// when the launch runs more than one layer.
static cudaError_t launch_refenc_bf16(const RbLaunch& P, int bands, int B, int smem,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(refenc_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands, B, 1);
  cfg.blockDim = dim3(RB_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.l1 - P.l0 > 1 ? bands : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, refenc_bf16_kernel, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
