// K4 — the whole fixed-length autoregressive decode (Bahdanau or
// location-sensitive attention; GRU or, Tacotron 2's, LSTM cells), all rows
// of the batch stepping together, as ordinary phase launches a step over the
// whole card.
//
// Replaces: gst_tacotron_tpu/ops/decode_pallas.py::decode_scan_pallas
//           (kernel _decode_kernel), both branches. The LSTM branch has no
//           TPU counterpart.
//
// Each step, per utterance: prenet (2 x dense + ReLU, optional inverted
// dropout) of the last frame -> attention GRU over [prenet ; context] ->
// query projection -> scores v . tanh(keys + q + loc), -1e9 at masked
// positions -> softmax masked again, with its denominator clamped at 1e-9 ->
// context sum_t align[t] * memory[t] -> decoder input projection of
// [query ; context] -> two residual GRUs -> one packed frame + stop
// projection of [h ; context] -> the frame in slot r-1 feeds the next step.
// Position 0 is always valid, so a row of length 0 gets a one-hot alignment.
//
// Location term: loc[t][a] = sum_{j,c} feat_c[t + j - (k-1)/2] *
// loca[j*c_n + c][a] over the previous alignment (c = 0) and, when
// cumulative, the running sum of alignments (c = 1), zero outside [0, T): a
// direct k-tap sum (the TPU kernel's banded-Toeplitz matrix is not carried
// over). After the softmax: prev = align, cum += align. Bahdanau attention
// runs the same score code with one zero tap (k = c_n = 1).
//
// Dropout draws one Philox4x32-10 number per prenet unit, keyed by the seed
// and counted by (unit >> 2, step, layer, row0 + row), as a uniform strictly inside
// (0, 1); a unit is kept when the draw is >= rate and then scaled by
// 1 / (1 - rate). row0 is the first row's index in a global batch, so a
// data-parallel shard draws the rows the whole batch would (0 otherwise).
// The stream differs from jax.random's and the TPU's.
//
// Bound on the H100 at the main-path shape (B=32, T=64, memory 512, keys
// 256, 200 steps at r=2; ~1.9 M weights): about 3.9 MFLOP a step and row,
// 25 GFLOP per synthesis against ~20 MB of inputs, weights and outputs, so
// the float32 pipe bounds it (about 0.37 ms at 67 TFLOP/s). Location-
// sensitive at config 3 (the same widths, r=1, 1000 steps): about 5.9 MFLOP
// a step and row, 189 GFLOP per synthesis, so about 2.8 ms. Each step
// depends on the one before, so what a step costs is its chain of
// dependent phases.
//
// Design: the state lives in a device workspace (layout, products and the
// CTAs' slices from ops/decode.py, passed in `dims`); the step loop runs
// here, one launch a phase, every launch over all rows (row groups of 32 on
// grid.y) and its CTAs over the card:
//   P1  prenet layer 1
//   P2  prenet layer 2
//   P3  attention GRU: p2 @ awi[prenet rows] plus the state products; a CTA
//       owns GRU units and so the z, r and n columns of each
//   P4  q = h_attn @ qproj for a chunk of attention columns, then that
//       chunk's partial scores for every (row, position)
//   P5  per (row, slice of the context): the chunks' partial scores summed
//       in chunk order, mask, softmax, the context slice; slice 0 writes the
//       alignment, prev and cum. Every CTA of a row computes the same
//       softmax itself, so none waits for another
//   P6  decoder input projection; P7, P8 the residual GRUs; P9 frame and
//       stop projection, the last frame.
// The products of the state alone, which the next step's GRUs add (h_attn
// @ awh + abh, ctx @ awi[ctx rows] + abi, h_d1 @ g1wh + g1bh, h_d2 @ g2wh +
// g2bh), run off the critical path on spare CTAs of the first launch after
// their state is final: P7, P6, P8 and P9. Before step 0 they are the
// biases (a zero state).
// A product CTA owns consecutive quads of output columns (or GRU units) of
// one product over all k, and reads the transposed weights of those columns
// (copied once a call, so a warp's k-reads are contiguous) once a step: 7.9
// MB a step over the card, L2-resident. A warp computes an 8-row x 4-column
// tile; its lanes split k, and a reduce-scatter of shuffles adds the lanes'
// sums in a fixed order. Where a CTA has fewer tiles than warps, the warps
// also split k and add their sums in a fixed order in shared memory. No
// atomic goes into any sum: a seed gives the same bits on every run. No
// cooperative launch and no grid barrier: the launch boundaries order the
// phases.
//
// The LSTM branch (Tacotron 2; cell 1 in the header): prenet -> attention
// LSTM over [prenet ; context] -> the same attention -> decoder LSTM over
// [h_attn ; context] -> frame and stop of [h_dec ; context]. An LSTM unit's
// gates are i, f, g, o; c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c').
// Each LSTM's input and recurrent rows are one packed matrix and its two
// biases one sum, so a unit's pre-activation is [x ; h] @ W + b:
//   P3  attention LSTM: p2 @ awi[prenet rows] plus the state product; a CTA
//       owns units and so the i, f, g and o columns of each
//   P7  decoder LSTM: [h_attn ; ctx] @ dwi[those rows] plus its state
//       product, beside the attention LSTM's state product [ctx ; h_attn]
//       @ awi[the rest] + abi (ctx is final after P5, h_attn after P3)
//   P9  frame and stop, beside the decoder LSTM's state product h_dec @
//       dwi[h_dec rows] + dbi
// P6 and P8 do not launch. At the cell's width (B=32, T=192, memory 768,
// LSTMs of 1024, attention 128, r=1, 1000 steps) the packed weights are
// about 81 MB, past the card's 50 MB L2: a step streams them from HBM
// (about 24 us at 3.35 TB/s), and a step is about 44 MFLOP a row.
//
// Resuming (the chunked decode): a call runs steps [step0, step0 + nsteps)
// of a decode of S steps, S the row stride of the outputs (B, S * r, M),
// (B, S * r) and (B, S, T). The first call (prepared 0) zeroes the state,
// transposes the keys and the weights into the workspace and seeds the
// alignment; a continuation (prepared 1) finds all of that in the workspace
// as the call before left it, and does none of it again. The dropout draw
// is keyed by the global step, so a decode in chunks draws the masks of one
// call and gives its bits.

#include "common.cuh"

#define DEC_THREADS 256
#define DEC_WARPS (DEC_THREADS / 32)
#define DEC_ROWS 32   // rows a CTA: a row group
#define NHDR 19       // ops/decode.py::decode_launch_ints, in order
#define NBUF 23
#define NPROD 12      // the most products a branch has
#define PROD_INTS 14

// the workspace's state buffers (ops/decode.py BUFFERS)
enum Buf { H_ATTN, H_D1, H_D2, CTX, P1B, P2B, LAST, HDEC0, HDEC1, HDEC2, GHA, GXC, GH1, GH2,
           PREV, CUM, PART, KEYS_T, C_ATTN, H_DEC, C_DEC, GSA, GSD };
// the products (ops/decode.py::KINDS)
enum Kind { K_PRE1, K_GHA, K_GXC, K_GH1, K_GH2, K_PRE2, K_ATTN, K_QUERY, K_DEC, K_G1, K_G2,
            K_OUT, K_LATTN, K_GSA, K_LDEC, K_GSD };

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
  int B, T, S, r, NM, P1, P2, Ha, A, Hd, Md, loc_k, loc_c;
  int chunks, slice_w, slices, state_floats, cell, nprod;
};

struct State {
  float* buf[NBUF];
  int ld[NBUF];  // row strides
};

// One product: Y = [X0 ; X1] @ W, W transposed to (gates * n4, kp) rows of
// k, each input segment padded to a multiple of 4 with zeros.
struct Prod {
  float* wt;
  const float *x0, *x1;
  int ld0, ld1, f0, f1;  // input row strides; float4s of each segment
  int n, n4, gates, qpc, ncta, kind;
};

struct Phase {
  int n;
  Prod p[5];
};

struct Ctx {
  State s;
  DecodeWeights w;
  DecodeDims d;
  const float* memory;
  const int* lengths;
  float *mel, *stop, *align;
  unsigned long long seed;
  float rate;
  int use_dropout, step, row0;
};

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

__device__ __forceinline__ float prenet_unit(float v, int unit, int step, int layer, int row,
                                             unsigned long long seed, float rate,
                                             int use_dropout) {
  v = fmaxf(v, 0.0f);
  if (!use_dropout) return v;
  Philox4 p = philox4x32_10((uint32_t)(unit >> 2), (uint32_t)step, (uint32_t)layer,
                            (uint32_t)row, (uint32_t)seed, (uint32_t)(seed >> 32));
  float u = uniform_open01(p.v[unit & 3]);
  return u >= rate ? v / (1.0f - rate) : 0.0f;
}

// One halving step of the reduce-scatter: lanes with bit O keep the upper
// half of the live values, and each adds its partner's copy of what it keeps.
template <int O>
__device__ __forceinline__ void scatter_step(float* a, bool up) {
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float keep = up ? a[O + j] : a[j], send = up ? a[j] : a[O + j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// An 8-row x 4-column tile of [X0 ; X1] @ W for each of G gates, over the
// float4s f of k with f = 32 * (part + parts * m) + lane: rows b0 .. b0 + 7
// (past B they repeat row B - 1 and are not emitted), columns the four
// transposed weight rows of quad q in each gate's block. Each lane keeps
// its k's partial sums in registers; a reduce-scatter a gate leaves lane l
// the tile's output l (row l >> 2, column l & 3) in out[g].
template <int G>
__device__ __forceinline__ void warp_tile(const Prod& p, int q, int b0, int B, int part,
                                          int parts, float* out) {
  const int lane = threadIdx.x & 31;
  const int nf = p.f0 + p.f1, kp = 4 * nf;
  const float* wt = p.wt + (size_t)4 * q * kp;
  float acc[G][32];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[g][v] = 0.0f;
  for (int f = 32 * part + lane; f < nf; f += 32 * parts) {
    const bool s0 = f < p.f0;
    const float* x = s0 ? p.x0 + 4 * f : p.x1 + 4 * (f - p.f0);
    const int ld = s0 ? p.ld0 : p.ld1;
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = __ldg(reinterpret_cast<const float4*>(x + (size_t)min(b0 + i, B - 1) * ld));
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 w = __ldg(
            reinterpret_cast<const float4*>(wt + ((size_t)g * p.n4 + c) * kp + 4 * f));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float& a = acc[g][4 * i + c];
          a = fmaf(xv[i].x, w.x, a);
          a = fmaf(xv[i].y, w.y, a);
          a = fmaf(xv[i].z, w.z, a);
          a = fmaf(xv[i].w, w.w, a);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    scatter_step<16>(acc[g], lane & 16);
    scatter_step<8>(acc[g], lane & 8);
    scatter_step<4>(acc[g], lane & 4);
    scatter_step<2>(acc[g], lane & 2);
    scatter_step<1>(acc[g], lane & 1);
    out[g] = acc[g][0];
  }
}

// What an output's epilogue reads besides its product, loaded before the
// product so that the loads' latency hides under it.
struct EpiIn {
  float a[8];
};

// A CTA's job: quads q0 .. q0 + nq - 1 of product p (each gate of a GRU or
// LSTM unit quad) for rows row0 .. row0 + nr - 1. The tiles go round the
// warps; with fewer tiles than warps, ks warps split each tile's k and their
// sums are added in warp order. For each output: in = load(b, j) first, then
// emit(b, j, v[gates], in). GMAX is the most gates the launch's products
// have: 3 (GRU) or 4 (LSTM).
template <int GMAX, class Load, class Emit>
__device__ __forceinline__ void cta_products(const Prod& p, int q0, int nq, int row0, int nr,
                                             int B, Load load, Emit emit) {
  __shared__ float red[DEC_WARPS][GMAX][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rsub = (nr + 7) >> 3, tiles = nq * rsub;
  const int ks = max(1, DEC_WARPS / tiles), per = DEC_WARPS / ks;
  for (int t0 = 0; t0 < tiles; t0 += per) {
    const int t = t0 + warp / ks, part = warp % ks;
    const bool live = warp < per * ks && t < tiles;
    const int q = q0 + t / rsub, b0 = row0 + 8 * (t % rsub);
    const int b = b0 + (lane >> 2), j = 4 * q + (lane & 3);
    const bool out = live && part == 0 && b < row0 + nr && j < p.n;
    EpiIn in;
    if (out) in = load(b, j);
    if (live) {
      float r[GMAX];
      if (p.gates == GMAX)
        warp_tile<GMAX>(p, q, b0, B, part, ks, r);
      else
        warp_tile<1>(p, q, b0, B, part, ks, r);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < p.gates) red[warp][g][lane] = r[g];
    }
    __syncthreads();
    if (out) {
      float v[GMAX] = {};
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < p.gates)
          for (int u = 0; u < ks; ++u) v[g] += red[warp + u][g][lane];
      emit(b, j, v, in);
    }
    __syncthreads();
  }
}

// The operands of output (row b, column or unit j) of each product.
__device__ __forceinline__ EpiIn epi_load(const Ctx& c, int kind, int b, int j) {
  const DecodeDims& d = c.d;
  const State& s = c.s;
  const DecodeWeights& w = c.w;
  EpiIn e;
  switch (kind) {
    case K_PRE1:
    case K_PRE2:
      e.a[0] = (kind == K_PRE1 ? w.pb1 : w.pb2)[j];
      break;
    case K_GHA:
    case K_GXC:
    case K_GH1:
    case K_GH2: {
      const float* bias = kind == K_GHA ? w.abh : kind == K_GXC ? w.abi : kind == K_GH1 ? w.g1bh
                                                                                       : w.g2bh;
      const int H = kind <= K_GXC ? d.Ha : d.Hd;
      for (int g = 0; g < 3; ++g) e.a[g] = bias[g * H + j];
      break;
    }
    case K_ATTN: {
      const int H4 = (d.Ha + 3) & ~3;
      const float* gx = s.buf[GXC] + (size_t)b * s.ld[GXC];
      const float* gh = s.buf[GHA] + (size_t)b * s.ld[GHA];
      for (int g = 0; g < 3; ++g) {
        e.a[g] = gx[g * H4 + j];
        e.a[3 + g] = gh[g * H4 + j];
      }
      e.a[6] = s.buf[H_ATTN][(size_t)b * s.ld[H_ATTN] + j];
      break;
    }
    case K_DEC:
      e.a[0] = w.dbi[j];
      break;
    case K_G1:
    case K_G2: {
      const bool one = kind == K_G1;
      const int H = d.Hd, H4 = (H + 3) & ~3;
      const float* bi = one ? w.g1bi : w.g2bi;
      const float* gh = s.buf[one ? GH1 : GH2] + (size_t)b * s.ld[GH1];
      for (int g = 0; g < 3; ++g) {
        e.a[g] = bi[g * H + j];
        e.a[3 + g] = gh[g * H4 + j];
      }
      e.a[6] = s.buf[one ? H_D1 : H_D2][(size_t)b * s.ld[H_D1] + j];
      e.a[7] = s.buf[one ? HDEC0 : HDEC1][(size_t)b * s.ld[HDEC0] + j];
      break;
    }
    case K_OUT:
      e.a[0] = w.fb[j];
      break;
    case K_GSA:
    case K_GSD: {
      const float* bias = kind == K_GSA ? w.abi : w.dbi;
      const int H = kind == K_GSA ? d.Ha : d.Hd;
      for (int g = 0; g < 4; ++g) e.a[g] = bias[g * H + j];
      break;
    }
    case K_LATTN:
    case K_LDEC: {
      const bool att = kind == K_LATTN;
      const int H4 = ((att ? d.Ha : d.Hd) + 3) & ~3;
      const int gs = att ? GSA : GSD, cb = att ? C_ATTN : C_DEC;
      const float* st = s.buf[gs] + (size_t)b * s.ld[gs];
      for (int g = 0; g < 4; ++g) e.a[g] = st[g * H4 + j];
      e.a[4] = s.buf[cb][(size_t)b * s.ld[cb] + j];
      break;
    }
  }
  return e;
}

// One LSTM unit (gate order i, f, g, o): the new (h, c) from its summed
// pre-activations and its cell state.
__device__ __forceinline__ void lstm_update(float gi, float gf, float gg, float go, float c,
                                            float& h_out, float& c_out) {
  c_out = sigmoidf_(gf) * c + sigmoidf_(gi) * tanhf(gg);
  h_out = sigmoidf_(go) * tanhf(c_out);
}

// What each product does with output (b, j): its sums v and operands e.
__device__ __forceinline__ void epilogue(const Ctx& c, int kind, int b, int j, const float* v,
                                         const EpiIn& e) {
  const DecodeDims& d = c.d;
  const State& s = c.s;
  switch (kind) {
    case K_PRE1:
    case K_PRE2: {
      const int layer = kind == K_PRE1 ? 0 : 1, buf = layer ? P2B : P1B;
      s.buf[buf][(size_t)b * s.ld[buf] + j] =
          prenet_unit(v[0] + e.a[0], j, c.step, layer, c.row0 + b, c.seed, c.rate,
                      c.use_dropout);
      break;
    }
    case K_GHA:
    case K_GXC:
    case K_GH1:
    case K_GH2: {
      const int buf = kind == K_GHA ? GHA : kind == K_GXC ? GXC : kind == K_GH1 ? GH1 : GH2;
      const int H4 = ((kind <= K_GXC ? d.Ha : d.Hd) + 3) & ~3;
      float* out = s.buf[buf] + (size_t)b * s.ld[buf];
      for (int g = 0; g < 3; ++g) out[g * H4 + j] = v[g] + e.a[g];
      break;
    }
    case K_ATTN:
      s.buf[H_ATTN][(size_t)b * s.ld[H_ATTN] + j] =
          gru_update(v[0] + e.a[0], v[1] + e.a[1], v[2] + e.a[2], e.a[3], e.a[4], e.a[5], e.a[6]);
      break;
    case K_DEC:
      s.buf[HDEC0][(size_t)b * s.ld[HDEC0] + j] = v[0] + e.a[0];
      break;
    case K_G1:
    case K_G2: {
      const bool one = kind == K_G1;
      const float hn =
          gru_update(v[0] + e.a[0], v[1] + e.a[1], v[2] + e.a[2], e.a[3], e.a[4], e.a[5], e.a[6]);
      s.buf[one ? H_D1 : H_D2][(size_t)b * s.ld[H_D1] + j] = hn;
      s.buf[one ? HDEC1 : HDEC2][(size_t)b * s.ld[HDEC0] + j] = e.a[7] + hn;
      break;
    }
    case K_OUT: {
      const float o = v[0] + e.a[0];
      const size_t frame0 = (size_t)b * d.S * d.r + (size_t)c.step * d.r;
      if (j < d.r * d.NM) {
        c.mel[(frame0 + j / d.NM) * d.NM + j % d.NM] = o;
        if (j >= (d.r - 1) * d.NM) s.buf[LAST][(size_t)b * s.ld[LAST] + j - (d.r - 1) * d.NM] = o;
      } else {
        c.stop[frame0 + j - d.r * d.NM] = o;
      }
      break;
    }
    case K_GSA:
    case K_GSD: {
      const int buf = kind == K_GSA ? GSA : GSD;
      const int H4 = ((kind == K_GSA ? d.Ha : d.Hd) + 3) & ~3;
      float* out = s.buf[buf] + (size_t)b * s.ld[buf];
      for (int g = 0; g < 4; ++g) out[g * H4 + j] = v[g] + e.a[g];
      break;
    }
    case K_LATTN:
    case K_LDEC: {
      const bool att = kind == K_LATTN;
      const int hb = att ? H_ATTN : H_DEC, cb = att ? C_ATTN : C_DEC;
      float h, cn;
      lstm_update(v[0] + e.a[0], v[1] + e.a[1], v[2] + e.a[2], v[3] + e.a[3], e.a[4], h, cn);
      s.buf[hb][(size_t)b * s.ld[hb] + j] = h;
      s.buf[cb][(size_t)b * s.ld[cb] + j] = cn;
      break;
    }
  }
}

// P1, P2, P3, P6, P7, P8, P9: the phase's products, one job a CTA (the
// products' CTAs in order along grid.x), a row group on grid.y; GMAX as
// cta_products takes it.
template <int PH, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS) decode_phase(Phase ph, Ctx c) {
  int cta = blockIdx.x, i = 0;
  while (i + 1 < ph.n && cta >= ph.p[i].ncta) cta -= ph.p[i++].ncta;
  const Prod p = ph.p[i];
  const int q0 = cta * p.qpc, nq = min(p.qpc, p.n4 / 4 - q0);
  const int row0 = blockIdx.y * DEC_ROWS, nr = min(DEC_ROWS, c.d.B - row0);
  cta_products<GMAX>(
      p, q0, nq, row0, nr, c.d.B, [&](int b, int j) { return epi_load(c, p.kind, b, j); },
      [&](int b, int j, const float* v, const EpiIn& e) { epilogue(c, p.kind, b, j, v, e); });
}

__device__ __forceinline__ float feature(const float* f, int t, int T) {
  return t >= 0 && t < T ? f[t] : 0.0f;
}

// P4: chunk blockIdx.x of the attention columns. The query of the chunk's
// columns for the row group, then for every (row, position) the chunk's
// partial score sum_a v_a tanh(keys + q + loc), a ascending.
__global__ void __launch_bounds__(DEC_THREADS) decode_scores(Prod p, Ctx c) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const DecodeDims& d = c.d;
  const int ch = blockIdx.x, q0 = ch * p.qpc, nq = min(p.qpc, p.n4 / 4 - q0);
  const int na = 4 * nq, nas = 4 * p.qpc;
  const int row0 = blockIdx.y * DEC_ROWS, nr = min(DEC_ROWS, d.B - row0);
  const int KC = d.loc_k * d.loc_c, pad = (d.loc_k - 1) / 2;
  float* qs = sm;                     // [DEC_ROWS][nas] the query
  float* locs = qs + DEC_ROWS * nas;  // [KC][nas] the chunk's location taps
  float* vs = locs + KC * nas;        // [nas]
  for (int i = threadIdx.x; i < KC * na; i += blockDim.x) {
    const int jc = i / na, a = 4 * q0 + i % na;
    locs[jc * nas + i % na] = a < d.A ? c.w.loca[(size_t)jc * d.A + a] : 0.0f;
  }
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    const int a = 4 * q0 + i;
    vs[i] = a < d.A ? c.w.vvec[a] : 0.0f;
  }
  cta_products<3>(
      p, q0, nq, row0, nr, d.B, [](int, int) { return EpiIn(); },
      [&](int b, int j, const float* v, const EpiIn&) { qs[(b - row0) * nas + j - 4 * q0] = v[0]; });

  // a thread: 4 positions of a row; a window of 4 features slides over the
  // taps, so each tap is one feature load, one float4 of taps and 16 FMAs
  const float* kt = c.s.buf[KEYS_T];
  const int ntq = (d.T + 3) >> 2;
  for (int it = threadIdx.x; it < nr * ntq; it += blockDim.x) {
    const int bl = it / ntq, t0 = 4 * (it - bl * ntq), b = row0 + bl;
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int qq = 0; qq < nq; ++qq) {
      float l[4][4] = {};  // [position][column]
      for (int cc = 0; cc < d.loc_c; ++cc) {
        const float* f = c.s.buf[cc == 0 ? PREV : CUM] + (size_t)b * d.T;
        float win[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) win[i] = feature(f, t0 - pad + i, d.T);
        for (int j = 0; j < d.loc_k; ++j) {
          const float4 wv =
              *reinterpret_cast<const float4*>(locs + (j * d.loc_c + cc) * nas + 4 * qq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            l[i][0] = fmaf(win[i], wv.x, l[i][0]);
            l[i][1] = fmaf(win[i], wv.y, l[i][1]);
            l[i][2] = fmaf(win[i], wv.z, l[i][2]);
            l[i][3] = fmaf(win[i], wv.w, l[i][3]);
          }
          win[0] = win[1];
          win[1] = win[2];
          win[2] = win[3];
          win[3] = feature(f, t0 + j + 4 - pad, d.T);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = 4 * (q0 + qq) + u;
        if (a >= d.A) continue;
        const float* kr = kt + ((size_t)b * d.A + a) * d.T;
        const float qa = qs[bl * nas + 4 * qq + u], va = vs[4 * qq + u];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (t0 + i < d.T) sc[i] = fmaf(va, tanhf(kr[t0 + i] + qa + l[i][u]), sc[i]);
      }
    }
    float* out = c.s.buf[PART] + ((size_t)b * d.chunks + ch) * d.T;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i < d.T) out[t0 + i] = sc[i];
  }
}

// P5: row blockIdx.y, context columns of slice blockIdx.x. Every CTA of a
// row recomputes the row's softmax in the same order (the same bits).
__global__ void __launch_bounds__(DEC_THREADS) decode_attend(Ctx c) {
  extern __shared__ float4 smem4[];
  float* al = reinterpret_cast<float*>(smem4);  // [T]
  float* red = al + ((c.d.T + 3) & ~3);         // [max(T, DEC_THREADS)]
  __shared__ float scratch32[32];
  const DecodeDims& d = c.d;
  const int b = blockIdx.y, slice = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int len = c.lengths[b];
  const float* pt = c.s.buf[PART] + (size_t)b * d.chunks * d.T;
  // the chunks' partial scores: G groups of consecutive chunks, each summed
  // by its own thread, then the groups in order
  const int G = max(1, min(d.chunks, nthr / d.T)), per = (d.chunks + G - 1) / G;
  for (int i = tid; i < G * d.T; i += nthr) {
    const int g = i / d.T, t = i - g * d.T, k1 = min(d.chunks, (g + 1) * per);
    float v = 0.0f;
#pragma unroll 8
    for (int k = g * per; k < k1; ++k) v += pt[(size_t)k * d.T + t];
    red[i] = v;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int t = tid; t < d.T; t += nthr) {
    float v = 0.0f;
    for (int g = 0; g < G; ++g) v += red[g * d.T + t];
    v = (t < len || t == 0) ? v : -1e9f;
    al[t] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce(mx, true, scratch32);
  float sum = 0.0f;
  for (int t = tid; t < d.T; t += nthr) {
    const float e = (t < len || t == 0) ? expf(al[t] - mx) : 0.0f;
    al[t] = e;
    sum += e;
  }
  sum = fmaxf(block_reduce(sum, false, scratch32), 1e-9f);
  for (int t = tid; t < d.T; t += nthr) {
    const float a = al[t] / sum;
    al[t] = a;
    if (slice == 0) {
      c.align[((size_t)b * d.S + c.step) * d.T + t] = a;
      c.s.buf[PREV][(size_t)b * d.T + t] = a;   // prev = align
      c.s.buf[CUM][(size_t)b * d.T + t] += a;   // cum += align
    }
  }
  __syncthreads();
  const int m0 = slice * d.slice_w, mw = min(d.slice_w, d.Md - m0);
  const int parts = nthr / d.slice_w, m = tid % d.slice_w, part = tid / d.slice_w;
  const float* mem = c.memory + (size_t)b * d.T * d.Md + m0;
  float acc = 0.0f;
  if (part < parts && m < mw)
    for (int t = part; t < d.T; t += parts) acc = fmaf(al[t], mem[(size_t)t * d.Md + m], acc);
  if (part < parts) red[part * d.slice_w + m] = acc;
  __syncthreads();
  if (tid < mw) {
    float s = 0.0f;
    for (int u = 0; u < parts; ++u) s += red[u * d.slice_w + tid];
    c.s.buf[CTX][(size_t)b * c.s.ld[CTX] + m0 + tid] = s;
  }
}

// Once a call: the keys transposed to (B, A, T) and the alignment state's
// delta at position 0 (the rest of the state is zeroed before).
__global__ void decode_prep(Ctx c, const float* __restrict__ keys) {
  const DecodeDims& d = c.d;
  const size_t n = (size_t)d.B * d.A * d.T, stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const size_t t = i % d.T, ba = i / d.T, a = ba % d.A, b = ba / d.A;
    c.s.buf[KEYS_T][i] = keys[(b * d.T + t) * d.A + a];
  }
  for (size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x; b < (size_t)d.B; b += stride)
    c.s.buf[PREV][b * d.T] = 1.0f;
  // the state products of the zero state: their biases (GRU: 3 gates of
  // four products; LSTM: 4 gates of two)
  const bool lstm = d.cell == 1;
  const int nk = lstm ? 2 : 4, G = lstm ? 4 : 3;
  const int bufs[4] = {lstm ? GSA : GHA, lstm ? GSD : GXC, GH1, GH2};
  const float* bias[4] = {lstm ? c.w.abi : c.w.abh, lstm ? c.w.dbi : c.w.abi, c.w.g1bh,
                          c.w.g2bh};
  for (int k = 0; k < nk; ++k) {
    const int H = (lstm ? k == 0 : k < 2) ? d.Ha : d.Hd, H4 = (H + 3) & ~3;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)d.B * G * H;
         i += stride) {
      const size_t b = i / (G * H);
      const int gj = (int)(i - b * G * H), g = gj / H, j = gj - g * H;
      c.s.buf[bufs[k]][b * c.s.ld[bufs[k]] + g * H4 + j] = bias[k][gj];
    }
  }
}

// Once a call: a product's weights transposed to (gates * n4, kp): row
// g * n4 + u holds column g * n + u of the source over the rows of each
// segment, zero past n and past each segment.
__global__ void decode_prep_weights(Prod p, const float* __restrict__ src, int ld, int r0,
                                    int n0, int r1, int n1) {
  const int kp = 4 * (p.f0 + p.f1);
  const size_t n = (size_t)p.gates * p.n4 * kp, stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int row = (int)(i / kp), kk = (int)(i % kp);
    const int g = row / p.n4, u = row % p.n4;
    int k = -1;
    if (kk < 4 * p.f0) {
      if (kk < n0) k = r0 + kk;
    } else if (kk - 4 * p.f0 < n1) {
      k = r1 + kk - 4 * p.f0;
    }
    p.wt[i] = (u < p.n && k >= 0) ? src[(size_t)k * ld + g * p.n + u] : 0.0f;
  }
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int decode_scan_launch(const float* memory, const float* keys,
                                  const int* lengths,
                                  const float* const* weights,  // host array, DecodeWeights order
                                  const int* dims,              // host array, decode_launch_ints
                                  float* mel_out, float* stop_out, float* align_out,
                                  float* work, unsigned long long seed, float rate,
                                  int use_dropout, int step0, int nsteps, int prepared,
                                  int row0, cudaStream_t stream) {
  Ctx c;
  const float** wp = reinterpret_cast<const float**>(&c.w);
  for (int i = 0; i < (int)(sizeof(DecodeWeights) / sizeof(const float*)); ++i) wp[i] = weights[i];
  int* dp = reinterpret_cast<int*>(&c.d);
  for (int i = 0; i < NHDR; ++i) dp[i] = dims[i];
  const DecodeDims& d = c.d;
  const int B = d.B;
  for (int i = 0; i < NBUF; ++i) {
    c.s.buf[i] = work + dims[NHDR + 2 * i];
    c.s.ld[i] = dims[NHDR + 2 * i + 1];
  }
  c.memory = memory;
  c.lengths = lengths;
  c.mel = mel_out;
  c.stop = stop_out;
  c.align = align_out;
  c.seed = seed;
  c.rate = rate;
  c.use_dropout = use_dropout;
  c.step = step0;
  c.row0 = row0;
  if (row0 < 0 || step0 < 0 || nsteps < 0 || step0 + nsteps > d.S)
    return (int)cudaErrorInvalidValue;

  cudaError_t err;
  if (!prepared) {
    err = cudaMemsetAsync(work, 0, (size_t)d.state_floats * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    decode_prep<<<264, 256, 0, stream>>>(c, keys);
  }

  if (d.nprod < 1 || d.nprod > NPROD) return (int)cudaErrorInvalidValue;
  Phase ph[10] = {};
  for (int k = 0; k < d.nprod; ++k) {
    const int* q = dims + NHDR + 2 * NBUF + k * PROD_INTS;
    Prod p;
    p.kind = q[0];
    p.wt = work + q[1];
    p.n = q[4];
    p.gates = q[5];
    p.n4 = (p.n + 3) & ~3;
    p.f0 = (q[7] + 3) / 4;
    p.f1 = (q[9] + 3) / 4;
    p.x0 = c.s.buf[q[10]];
    p.ld0 = c.s.ld[q[10]];
    p.x1 = q[11] >= 0 ? c.s.buf[q[11]] : nullptr;
    p.ld1 = q[11] >= 0 ? c.s.ld[q[11]] : 0;
    p.qpc = q[12];
    p.ncta = (p.n4 / 4 + p.qpc - 1) / p.qpc;
    if (!prepared)
      decode_prep_weights<<<132, 256, 0, stream>>>(p, weights[q[2]], q[3], q[6], q[7], q[8],
                                                   q[9]);
    Phase& f = ph[q[13]];
    f.p[f.n++] = p;
  }
  int grid[10] = {};
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < ph[i].n; ++j) grid[i] += ph[i].p[j].ncta;
  const int groups = (B + DEC_ROWS - 1) / DEC_ROWS;
  const int nas = 4 * ph[4].p[0].qpc;
  const size_t smem_scores = sizeof(float) * (size_t)nas * (DEC_ROWS + d.loc_k * d.loc_c + 1);
  const size_t smem_attend =
      sizeof(float) * (((d.T + 3) & ~3) + (size_t)(d.T > DEC_THREADS ? d.T : DEC_THREADS));
  int rc = set_smem((const void*)decode_scores, smem_scores);
  if (rc == 0) rc = set_smem((const void*)decode_attend, smem_attend);
  if (rc != 0) return rc;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 blk(DEC_THREADS);
  if (d.cell == 1) {
    for (int step = step0; step < step0 + nsteps; ++step) {
      c.step = step;
      decode_phase<1, 3><<<dim3(grid[1], groups), blk, 0, stream>>>(ph[1], c);
      decode_phase<2, 3><<<dim3(grid[2], groups), blk, 0, stream>>>(ph[2], c);
      decode_phase<3, 4><<<dim3(grid[3], groups), blk, 0, stream>>>(ph[3], c);
      decode_scores<<<dim3(grid[4], groups), blk, smem_scores, stream>>>(ph[4].p[0], c);
      decode_attend<<<dim3(d.slices, B), blk, smem_attend, stream>>>(c);
      decode_phase<7, 4><<<dim3(grid[7], groups), blk, 0, stream>>>(ph[7], c);
      decode_phase<9, 4><<<dim3(grid[9], groups), blk, 0, stream>>>(ph[9], c);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
  }
  for (int step = step0; step < step0 + nsteps; ++step) {
    c.step = step;
    decode_phase<1, 3><<<dim3(grid[1], groups), blk, 0, stream>>>(ph[1], c);
    decode_phase<2, 3><<<dim3(grid[2], groups), blk, 0, stream>>>(ph[2], c);
    decode_phase<3, 3><<<dim3(grid[3], groups), blk, 0, stream>>>(ph[3], c);
    decode_scores<<<dim3(grid[4], groups), blk, smem_scores, stream>>>(ph[4].p[0], c);
    decode_attend<<<dim3(d.slices, B), blk, smem_attend, stream>>>(c);
    decode_phase<6, 3><<<dim3(grid[6], groups), blk, 0, stream>>>(ph[6], c);
    decode_phase<7, 3><<<dim3(grid[7], groups), blk, 0, stream>>>(ph[7], c);
    decode_phase<8, 3><<<dim3(grid[8], groups), blk, 0, stream>>>(ph[8], c);
    decode_phase<9, 3><<<dim3(grid[9], groups), blk, 0, stream>>>(ph[9], c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
