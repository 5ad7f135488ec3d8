// Griffin-Lim's bf16 iteration (audio.griffin_lim_bf16) in three launches:
// G1 the inverse DFT product, G2 the overlap-add, G3 the forward DFT product
// with the magnitude projection and the next momentum step in its epilogue.
//
// Replaces: no TPU kernel. The JAX package runs these iterations as XLA
// convolutions (JaxDSP's bf16 mode), and the port ran them as about 20
// library kernels an iteration (dsp/torch_dsp.py's plain loop, which stays
// the CPU's route and the oracle). It computes that loop's function: the
// real-pair DFT products over the window's live taps on operands rounded to
// bfloat16 where the plain loop rounds them (the momentum-extrapolated
// spectrum, the frames of the normalised, reflect-padded wave), float32 sums,
// float32 state, and every elementwise step in IEEE round-to-nearest with no
// contraction, so it differs from the plain loop only in the products'
// summation order. No atomics: the same bits every run.
//
// Bound on the H100 at the synthesis cells' shape (B = 32 rows of T = 1000
// frames, n_fft 2048, hop 256, 1024 live taps, 1025 bins, 30 iterations):
// the two products are 2 x 2 x 32,000 x 2,050 x 1,024 = 2.7e11 FLOP an
// iteration, 0.27 ms at the 989 TFLOP/s of the bf16 tensor cores (8.2 ms a
// call); the bytes G3's epilogue must move (the magnitude, the old and the
// new float32 state, the next bf16 operand: 24 bytes a bin, 787 MB) and G1's
// float32 frames (131 MB, written and read) take about 0.36 ms at 3.35 TB/s.
// So the products and G3's epilogue bound it, about 0.42 ms an iteration.
//
// Design:
// - G1 and G3 are one TMA-fed wgmma mainloop (gl_mainloop): a CTA owns a
//   128-row tile (two consumer warpgroups of wgmma m64, both operands from
//   shared memory) by BN columns; one producer warp streams the A and B
//   boxes of each 64-deep k-step through a ring of stages (128-byte
//   swizzle, completed on mbarriers), so the tensor cores read nothing but
//   shared memory, and the consumers keep one wgmma group in flight while
//   the next stage lands.
// - G1's A is the spectrum operand as G3 wrote it: bf16, re and im of a bin
//   side by side (2F columns, the row padded to 16 bytes; the tensor map
//   reads zeros past 2F), so no concatenation or cast runs between the
//   products; the inverse basis's K rows are interleaved to match. Tiles of
//   256 taps (wgmma n256), 4 stages, one CTA an SM; it writes the float32
//   frames.
// - G2 sums each output chunk's frame chunks in the plain loop's order
//   (chunk j = 0..3, from 0), divides by the window-square norm, crops, and
//   applies the reflect pad by index, writing the bf16 padded wave as rows
//   of hop samples (one thread a sample).
// - G3 never materialises the frames: frame r's taps are the padded wave's
//   chunks r + j0 .. r + j0 + nk - 1, so a k-step of 64 taps of a 128-frame
//   tile is one TMA box of that wave (rows t0 + j, the taps' columns): its
//   A operand. The forward basis's rows interleave each bin's cos and sin,
//   so a bin's re and im are neighbouring columns. Tiles of 64 bins (wgmma
//   n128; 17 tiles cover 1025 bins), 3 stages and at most 112 registers, so
//   two CTAs share an SM and one's epilogue runs beside the other's
//   products. The epilogue is bound by its bytes, so they stream: the
//   magnitude and the state are kept in G3's tile order ((tile, row, 64
//   bins), a CTA's share one contiguous block; ops/griffin_lim.py lays them
//   out once a call), the sums go through shared memory, and each thread
//   takes 4 neighbouring bins with 16-byte loads and stores. It writes the
//   projected state in place and the next iteration's operand
//   bf16(re + alpha (re - re_old)) (skipped in the last iteration). With
//   rows of 1025 bins (4,100 bytes), the row-major layout cut every CTA's
//   share into 128 runs of 240-480 bytes, and the epilogue alone ran at
//   half the memory's rate.
// Every product, and each CTA's part of G2, depends on nothing but its own
// inputs; the three launches follow each other on the stream.

#include "stft_bf16.cuh"

#define GL_BM 128                      // rows a tile: two consumer warpgroups of wgmma m64
#define GL_BK 64                       // k a ring stage: one 128-byte swizzle row of bf16
#define GL_THREADS 288                 // two consumer warpgroups, one producer warp
#define GL_A_BYTES (GL_BM * GL_BK * 2) // 16 KB
#define GL_INV_BN 256                  // G1: taps a tile
#define GL_FWD_BN 128                  // G3: (re, im) columns of 64 bins a tile
#define GL_FWD_BINS (GL_FWD_BN / 2)
#define GL_OLA_THREADS 256
#define GL_EPI_U 4                     // G3's epilogue: 4-bin groups a thread keeps in flight

// G1: 4 stages, one CTA an SM; G3: 3 stages, two CTAs an SM
template <int BN>
struct GlTile {
  static constexpr int kStages = BN == GL_INV_BN ? 4 : 3;
  static constexpr int kStage = GL_A_BYTES + BN * GL_BK * 2;  // a multiple of 1024
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

template <int N>
__device__ __forceinline__ void gl_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, float32, the warpgroup's fragments) += the 64 x 16 K-major bf16
// tile at `da` * the 16 x 256 K-major tile at `db` (both in shared memory)
__device__ __forceinline__ void wgmma_n256_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(1));
}

// d (64 x 128, float32, the warpgroup's fragments) += the 64 x 16 K-major bf16
// tile at `da` * the 16 x 128 K-major tile at `db` (both in shared memory)
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

template <int BN>
__device__ __forceinline__ void gl_wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void gl_wgmma<GL_INV_BN>(float (&d)[GL_INV_BN / 2], uint64_t da,
                                                    uint64_t db) {
  wgmma_n256_ss(d, da, db);
}
template <>
__device__ __forceinline__ void gl_wgmma<GL_FWD_BN>(float (&d)[GL_FWD_BN / 2], uint64_t da,
                                                    uint64_t db) {
  wgmma_n128_ss(d, da, db);
}

// The tile's products, A (128 x K) by B (BN x K, K-major), into each consumer
// warpgroup's 64 x BN float32 fragments. A's box of k-step ks is at column
// (ks % kpc) * 64, row arow + ks / kpc: G1 walks one spectrum row range
// (kpc = ksteps), G3 the wave's chunks (kpc = hop / 64: the next chunk of
// every frame is the next row). B's box is at (ks * 64, brow). Returns false
// in the producer warp, which has nothing more to do.
template <int BN>
__device__ __forceinline__ bool gl_mainloop(const CUtensorMap* amap, const CUtensorMap* bmap,
                                            int arow, int kpc, int brow, int ksteps,
                                            float (&acc)[BN / 2]) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int stage = GlTile<BN>::kStage, stages = GlTile<BN>::kStages;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {  // the producer
    if (lane == 0)
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % stages;
        if (ks >= stages) mbar_wait(&empty[s], ((ks / stages) - 1) & 1);
        uint8_t* dst = ring + s * stage;
        mbar_expect_tx(&full[s], stage);
        tma_load_2d(dst, amap, (ks % kpc) * GL_BK, arow + ks / kpc, &full[s]);
        tma_load_2d(dst + GL_A_BYTES, bmap, ks * GL_BK, brow, &full[s]);
      }
    return false;
  }
  const int wg = warp >> 2;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % stages;
    mbar_wait(&full[s], (ks / stages) & 1);
    const uint64_t da = sw128_desc(ring + s * stage + wg * 64 * 128);
    const uint64_t db = sw128_desc(ring + s * stage + GL_A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) gl_wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    gl_fence_regs(acc);
    // the previous k-step's group is done: its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    gl_fence_regs(acc);
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % stages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  gl_fence_regs(acc);
  return true;
}

// G1. Grid (taps / 256, ceil(M / 128)): frames (M, n_live) float32 = the
// spectrum operand (M, 2F) bf16 by the interleaved inverse basis.
__global__ void __launch_bounds__(GL_THREADS, 1)
griffin_lim_inverse_kernel(const __grid_constant__ CUtensorMap spec,
                           const __grid_constant__ CUtensorMap basis,
                           float* __restrict__ frames, int M, int n_live, int ksteps) {
  float acc[GL_INV_BN / 2];
  const int m0 = blockIdx.y * GL_BM, n0 = blockIdx.x * GL_INV_BN;
  if (!gl_mainloop<GL_INV_BN>(&spec, &basis, m0, ksteps, n0, ksteps, acc)) return;
  // fragment 4j + i: row 16 * warp + g + 8 * (i / 2), column 8j + 2t + i % 2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < GL_INV_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + g + 8 * h;
      if (row < M && col < n_live)
        *reinterpret_cast<float2*>(frames + (size_t)row * n_live + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// G2. One thread a sample of the bf16 wave (B rows of `chunks` chunks of hop
// samples: the reflect-padded signal's chunks j0 .. j0 + chunks - 1). The
// padded sample q is the cropped signal's sample |q - pad| reflected at its
// end (length L), which is the overlap-add's sample p = that + pad: the sum,
// from 0 in the order j = 0..nk-1, of tap j * hop + p % hop of frame
// p / hop - j0 - j where that frame exists, over the window-square norm.
__global__ void __launch_bounds__(GL_OLA_THREADS)
griffin_lim_ola_kernel(const float* __restrict__ frames, const float* __restrict__ norm,
                       __nv_bfloat16* __restrict__ wave, long long total, int T, int hop,
                       int j0, int nk, int chunks, int pad, int L) {
  const long long i = (long long)blockIdx.x * GL_OLA_THREADS + threadIdx.x;
  if (i >= total) return;
  const int e = (int)(i % hop);
  const long long rc = i / hop;
  const int c = (int)(rc % chunks), b = (int)(rc / chunks);
  int s = (c + j0) * hop + e - pad;
  if (s < 0)
    s = -s;
  else if (s >= L)
    s = 2 * (L - 1) - s;
  const int p = s + pad, cp = p / hop, e2 = p - cp * hop, n_live = nk * hop;
  float v = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const int r = cp - j0 - j;
    if (r >= 0 && r < T) v = __fadd_rn(v, __ldg(frames + ((size_t)b * T + r) * n_live + j * hop + e2));
  }
  wave[i] = __float2bfloat16_rn(__fdiv_rn(v, __ldg(norm + p)));
}

// G3. Grid (bin tiles, B * ceil(T / 128)): the 128 frames t0.. of row b, as
// the wave's chunk rows b * chunks + t0 + j, by the interleaved forward
// basis; the epilogue projects each bin onto its magnitude and steps the
// momentum. mag (tiles, B*T, 64) and state (tiles, B*T, 64, 2) float32 in G3's
// tile order (state in place); spec (rows, ldspec) bf16, the next G1's operand.
__global__ void __launch_bounds__(GL_THREADS, 2)
griffin_lim_forward_kernel(const __grid_constant__ CUtensorMap wave,
                           const __grid_constant__ CUtensorMap basis,
                           const float* __restrict__ mag, float* __restrict__ state,
                           __nv_bfloat16* __restrict__ spec, int T, int tiles_t, int chunks,
                           int kpc, int ksteps, int NF, int ldspec, float alpha, int write_next) {
  float acc[GL_FWD_BN / 2];
  const int b = blockIdx.y / tiles_t, t0 = (blockIdx.y % tiles_t) * GL_BM;
  const int nt = blockIdx.x, f0 = nt * GL_FWD_BINS, rows = min(GL_BM, T - t0);
  const size_t M = (size_t)gridDim.y / tiles_t * T;  // B * T
  // this CTA's contiguous blocks of the tile-order magnitude and state
  const size_t blk = ((size_t)nt * M + (size_t)b * T + t0) * GL_FWD_BINS;
  {
    // into L2 while the mainloop runs
    const int mlines = rows * GL_FWD_BINS * 4 / 128, lines = 3 * mlines;
    for (int i = threadIdx.x; i < lines; i += GL_THREADS) {
      const char* p = i < mlines ? reinterpret_cast<const char*>(mag + blk) + 128 * i
                                 : reinterpret_cast<const char*>(state + 2 * blk) + 128 * (i - mlines);
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(reinterpret_cast<uintptr_t>(p)));
    }
  }
  if (!gl_mainloop<GL_FWD_BN>(&wave, &basis, b * chunks + t0, kpc, nt * GL_FWD_BN, ksteps, acc))
    return;
  // the sums through shared memory (the ring, every stage consumed): row r's
  // (re, im) of bin f0 + q at columns 2q, 2q + 1
  constexpr int W = GL_FWD_BN + 4;  // a row's stride in floats (16-byte rows, fewer conflicts)
  extern __shared__ uint8_t smem_raw[];
  float* sums = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  {
    // fragment 4j + i: row 16 * warp + g + 8 * (i / 2), column 8j + 2t + i % 2
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // no wgmma of either warpgroup reads the ring
#pragma unroll
    for (int j = 0; j < GL_FWD_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sums + (16 * warp + g + 8 * h) * W + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
  // group i: row i / 16, bins 4 (i % 16) .. + 3: consecutive threads on
  // consecutive bytes of the blocks
  const float4* mg = reinterpret_cast<const float4*>(mag + blk);
  float4* st = reinterpret_cast<float4*>(state + 2 * blk);
  for (int i0 = threadIdx.x; i0 < rows * (GL_FWD_BINS / 4); i0 += 256 * GL_EPI_U) {
    float4 a[GL_EPI_U], o0[GL_EPI_U], o1[GL_EPI_U];
#pragma unroll
    for (int u = 0; u < GL_EPI_U; ++u) {
      const int i = i0 + 256 * u;
      if (i < rows * (GL_FWD_BINS / 4)) {
        a[u] = __ldg(mg + i);
        o0[u] = st[2 * i];
        o1[u] = st[2 * i + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < GL_EPI_U; ++u) {
      const int i = i0 + 256 * u;
      if (i >= rows * (GL_FWD_BINS / 4)) continue;
      const int r = i / (GL_FWD_BINS / 4), q = 4 * (i - r * (GL_FWD_BINS / 4));
      const float4 x0 = *reinterpret_cast<const float4*>(sums + r * W + 2 * q);
      const float4 x1 = *reinterpret_cast<const float4*>(sums + r * W + 2 * q + 4);
      const float xr[4] = {x0.x, x0.z, x1.x, x1.z}, xi[4] = {x0.y, x0.w, x1.y, x1.w};
      const float am[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      const float pr[4] = {o0[u].x, o0[u].z, o1[u].x, o1[u].z};
      const float pi[4] = {o0[u].y, o0[u].w, o1[u].y, o1[u].w};
      float re[4], im[4];
      __nv_bfloat162 nx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float n = __fsqrt_rn(__fadd_rn(__fmul_rn(xr[k], xr[k]), __fmul_rn(xi[k], xi[k])));
        const float scale = __fdiv_rn(am[k], fmaxf(n, 1e-16f));
        re[k] = __fmul_rn(xr[k], scale);
        im[k] = __fmul_rn(xi[k], scale);
        nx[k] = __floats2bfloat162_rn(__fadd_rn(re[k], __fmul_rn(alpha, __fsub_rn(re[k], pr[k]))),
                                      __fadd_rn(im[k], __fmul_rn(alpha, __fsub_rn(im[k], pi[k]))));
      }
      st[2 * i] = make_float4(re[0], im[0], re[1], im[1]);
      st[2 * i + 1] = make_float4(re[2], im[2], re[3], im[3]);
      const int f = f0 + q;
      if (!write_next || f >= NF) continue;
      __nv_bfloat16* sp = spec + ((size_t)b * T + t0 + r) * ldspec + 2 * f;
      if (f + 3 < NF) {  // 16 bytes: 2f and ldspec are multiples of 8
        uint4 v;
        memcpy(&v, nx, 16);
        *reinterpret_cast<uint4*>(sp) = v;
      } else {
        for (int k = 0; k < 4 && f + k < NF; ++k)
          *reinterpret_cast<__nv_bfloat162*>(sp + 2 * k) = nx[k];
      }
    }
  }
}

// a bf16 (rows, cols) matrix of row stride ld elements, read in boxes of 64
// columns by box_rows rows with the 128-byte swizzle; columns past cols read 0
static bool gl_tensor_map(CUtensorMap* map, const void* base, int cols, int rows, int ld,
                          int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {GL_BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
static cudaError_t gl_smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One Griffin-Lim iteration: G1, G2, G3 on `stream`.
//   spec      (spec_rows, ldspec) bf16, the operand (re, im interleaved, 2F
//             columns; rows past B*T zero), rewritten by G3 (write_next)
//   inv_basis (inv_rows, k1) bf16, k1 = 64 * ceil(2F / 64): tap n's row, its
//             columns 2f, 2f + 1 bin f's re and im weights, zero past 2F
//   fwd_basis (fwd_rows, n_live) bf16: rows 2f, 2f + 1 bin f's cos and -sin
//             taps, zero past 2F; fwd_rows = 128 * ceil(F / 64)
//   frames    (B*T, n_live) float32, G1 -> G2
//   norm      (hop * (T - 1) + n_fft,) float32, the window-square norm
//   wave      (B * chunks + 128, hop) bf16, chunks = T + nk - 1, G2 -> G3
//   mag       (fwd_rows / 128, B*T, 64) float32 and state (fwd_rows / 128,
//             B*T, 64, 2) float32 in G3's tile order (bins past F zero), state
//             read and written
extern "C" int griffin_lim_iteration_launch(void* spec, const void* inv_basis,
                                            const void* fwd_basis, float* frames,
                                            const float* norm, void* wave, const float* mag,
                                            float* state, int B, int T, int NF, int ldspec,
                                            int spec_rows, int n_live, int hop, int j0, int pad,
                                            int inv_rows, int fwd_rows, float alpha,
                                            int write_next, cudaStream_t stream) {
  const int M = B * T, nk = hop > 0 ? n_live / hop : 0, chunks = T + nk - 1;
  const int k1 = (2 * NF + GL_BK - 1) / GL_BK * GL_BK, L = hop * (T - 1);
  const int tiles_t = (T + GL_BM - 1) / GL_BM;
  if (B < 1 || T < 1 || NF < 1 || hop < GL_BK || hop % GL_BK || n_live < hop ||
      n_live % hop || ldspec < 2 * NF || ldspec % 8 || spec_rows < (M + GL_BM - 1) / GL_BM * GL_BM ||
      inv_rows < n_live || inv_rows % GL_INV_BN ||
      fwd_rows != (NF + GL_FWD_BINS - 1) / GL_FWD_BINS * GL_FWD_BN || pad < 1 || L <= pad ||
      j0 < 0 || (long long)B * tiles_t > 65535 || (M + GL_BM - 1) / GL_BM > 65535 ||
      (long long)M * k1 > (1LL << 31) || (long long)(B * chunks + GL_BM) * hop > (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap spec_map, inv_map, wave_map, fwd_map;
  if (!gl_tensor_map(&spec_map, spec, 2 * NF, spec_rows, ldspec, GL_BM) ||
      !gl_tensor_map(&inv_map, inv_basis, k1, inv_rows, k1, GL_INV_BN) ||
      !gl_tensor_map(&wave_map, wave, hop, B * chunks + GL_BM, hop, GL_BM) ||
      !gl_tensor_map(&fwd_map, fwd_basis, n_live, fwd_rows, n_live, GL_FWD_BN))
    return (int)cudaErrorInvalidValue;
  // per device, so every call
  cudaError_t err = gl_smem_attr(griffin_lim_inverse_kernel, GlTile<GL_INV_BN>::kSmem);
  if (err == cudaSuccess) err = gl_smem_attr(griffin_lim_forward_kernel, GlTile<GL_FWD_BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  griffin_lim_inverse_kernel<<<dim3(inv_rows / GL_INV_BN, (M + GL_BM - 1) / GL_BM),
                               GL_THREADS, GlTile<GL_INV_BN>::kSmem, stream>>>(
      spec_map, inv_map, frames, M, n_live, k1 / GL_BK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * chunks * hop;
  griffin_lim_ola_kernel<<<(unsigned)((total + GL_OLA_THREADS - 1) / GL_OLA_THREADS),
                           GL_OLA_THREADS, 0, stream>>>(
      frames, norm, reinterpret_cast<__nv_bfloat16*>(wave), total, T, hop, j0, nk, chunks, pad,
      L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  griffin_lim_forward_kernel<<<dim3(fwd_rows / GL_FWD_BN, B * tiles_t), GL_THREADS,
                               GlTile<GL_FWD_BN>::kSmem, stream>>>(
      wave_map, fwd_map, mag, state, reinterpret_cast<__nv_bfloat16*>(spec), T, tiles_t, chunks,
      hop / GL_BK, n_live / GL_BK, NF, ldspec, alpha, write_next);
  return (int)cudaGetLastError();
}
