// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every shared library exports the error text of a cudaError_t so that the
// Python wrapper can raise with it.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Keras-v2 GRU update (gate order z, r, n; reset_after): the new state from
// the input and recurrent gate pre-activations of one hidden unit.
__device__ __forceinline__ float gru_update(float xz, float xr, float xn,
                                            float hz, float hr, float hn,
                                            float h) {
  float z = sigmoidf_(xz + hz);
  float r = sigmoidf_(xr + hr);
  float n = tanhf(xn + r * hn);
  return z * h + (1.0f - z) * n;
}

// Philox4x32-10 (Salmon et al., SC'11): a counter-based generator, so every
// thread draws its own numbers from (key, counter) with no state.
struct Philox4 {
  uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    uint32_t n0 = hi1 ^ c1 ^ k0, n1 = lo1, n2 = hi0 ^ c3 ^ k1, n3 = lo0;
    c0 = n0; c1 = n1; c2 = n2; c3 = n3;
    k0 += W0; k1 += W1;
  }
  Philox4 r;
  r.v[0] = c0; r.v[1] = c1; r.v[2] = c2; r.v[3] = c3;
  return r;
}

// A uniform draw strictly inside (0, 1) from 32 random bits: the top 23 bits
// plus one half, scaled by 2^-23, so every value (2k+1) * 2^-24 is exact in
// float32 (with 24 bits, 2^24 - 1 + 0.5 rounds up to 2^24 and the draw to
// 1.0). Unsigned throughout.
__device__ __forceinline__ float uniform_open01(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
}

// c += a * b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// C 16x8 float32 (the bf16 kernels' mma.sync)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 4 bytes global -> shared without a register, or 4 zero bytes when !in
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
