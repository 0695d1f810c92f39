// Device helpers of the rollout kernel: Philox4x32-10, the [-1, 1) map of
// the random bits, Box-Muller normals and the tanh-MLP policy (one lane
// per env, or a team of G lanes per env).
//
// The plain PyTorch version (ops/megakernel.py: philox4x32, signed_unit,
// box_muller, and the matmul policy) computes the same functions, so kernel
// and plain version draw identical reset and exploration noise.
#pragma once
#include <stdint.h>

#ifndef OXC_HD
#ifdef __CUDACC__
#define OXC_HD __host__ __device__ __forceinline__
#else
#define OXC_HD inline
#endif
#endif

#define OXC_PHILOX_M0 0xD2511F53u
#define OXC_PHILOX_M1 0xCD9E8D57u
#define OXC_PHILOX_W0 0x9E3779B9u
#define OXC_PHILOX_W1 0xBB67AE85u
#define OXC_SALT_RESET 7u
#define OXC_SALT_EXPLORE 13u
#define OXC_MAX_LAYERS 4
#define OXC_MAX_WIDTH 64

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds, key bumped between
// rounds; counter 0 / key 0 -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8.
OXC_HD void oxc_philox4x32(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                           uint32_t k0, uint32_t k1, uint32_t out[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = (uint64_t)OXC_PHILOX_M0 * c0;
    const uint64_t p1 = (uint64_t)OXC_PHILOX_M1 * c2;
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += OXC_PHILOX_W0;
    k1 += OXC_PHILOX_W1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// n values of the stream (seed, salt) at (env, step), each as the int32
// value of its bits times 2^-31 (in [-1, 1]); value j is lane j % 4 of the
// block with counter (env, step, j / 4, 0).
OXC_HD void oxc_draw_signed(uint32_t seed, uint32_t salt, uint32_t env,
                            uint32_t step, int n, float* s) {
  uint32_t blk[4];
  for (int j = 0; j < n; ++j) {
    if ((j & 3) == 0) oxc_philox4x32(env, step, (uint32_t)(j >> 2), 0u,
                                     seed, salt, blk);
    s[j] = (float)(int32_t)blk[j & 3] * 0x1p-31f;
  }
}

// Box-Muller with u1 clamped away from 0: bits * 2^-31 rounds to exactly
// 1.0 in f32 for bits near 2^31, and log(0) = -inf would poison the sample.
OXC_HD float oxc_box_muller(float s1, float s2) {
  const float u1 = fmaxf(0.5f * (1.0f - s1), 1e-12f);  // (0, 1]
  const float u2 = 0.5f * (s2 + 1.0f);                  // [0, 1)
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318548f * u2);
}

// tanh-MLP on one env: W (out, in) row-major then b (out) per layer, read
// from shared memory (every thread of a warp reads the same word: a
// broadcast).  Per layer y = tanh(W x + b): the dot accumulates input by
// input, then the bias is added (the plain version's order).
OXC_HD void oxc_mlp(const float* params, int n_layers, const int* dims,
                    const float* obs, float* out) {
  float xa[OXC_MAX_WIDTH], xb[OXC_MAX_WIDTH];
  float* x = xa;
  float* y = xb;
  for (int i = 0; i < dims[0]; ++i) x[i] = obs[i];
  const float* p = params;
  for (int l = 0; l < n_layers; ++l) {
    const int nin = dims[l], nout = dims[l + 1];
    const float* w = p;
    const float* b = p + nout * nin;
    for (int o = 0; o < nout; ++o) {
      float acc = 0.0f;
      for (int i = 0; i < nin; ++i) acc = acc + w[o * nin + i] * x[i];
      y[o] = tanhf(acc + b[o]);
    }
    p += nout * nin + nout;
    float* t = x;
    x = y;
    y = t;
  }
  for (int o = 0; o < dims[n_layers]; ++o) out[o] = x[o];
}

#ifdef __CUDACC__
// tanh-MLP on one env, run by a team of G lanes of one warp (lane tl,
// lane mask tm): lane tl computes the outputs o = tl (mod G) of each
// layer, each dot product in oxc_mlp's order (input by input, then the
// bias), and a layer's outputs reach the team's lanes through the team's
// activation buffer xs (2 * OXC_MAX_WIDTH floats of shared memory, the
// observation in its first half on entry).  The weights stay in global
// memory, read through the L1 that every warp of the SM shares, in the
// transposed layout the wrapper packs for a team -- per layer W^T (in,
// out) row-major, then b (out) -- so the G lanes of a team, reading G
// consecutive outputs of one input, read one cache line.  Returns the
// buffer that holds the last layer's outputs.
template <int G>
__device__ __forceinline__ const float* oxc_mlp_team(
    const float* __restrict__ params, int n_layers, const int* dims,
    float* xs, int tl, unsigned tm) {
  float* x = xs;
  float* y = xs + OXC_MAX_WIDTH;
  const float* p = params;
  for (int l = 0; l < n_layers; ++l) {
    const int nin = dims[l], nout = dims[l + 1];
    __syncwarp(tm);  // x is whole; every lane is done with y
    for (int o = tl; o < nout; o += G) {
      float acc = 0.0f;
      for (int i = 0; i < nin; ++i)
        acc = acc + __ldg(p + i * nout + o) * x[i];
      y[o] = tanhf(acc + __ldg(p + nin * nout + o));
    }
    p += nout * nin + nout;
    float* t = x;
    x = y;
    y = t;
  }
  __syncwarp(tm);
  return x;
}
#endif
