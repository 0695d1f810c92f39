// K-step rollout kernel for Hopper (sm_90a): the hand-written shell.
//
// Replaces the TPU kernel oxide_control_tpu/ops/megakernel.py:build_rollout
// (one pl.pallas_call holding the whole engine).  One thread runs one env
// over the coordinate-major (rows, B) layout, so every load and store of a
// state row or trajectory row is coalesced across the warp.  The thread
// keeps its env's state in registers for all K steps: the loop inside the
// kernel takes the place of the TPU kernel's sequential chunk grid and its
// VMEM carry.  Per step: pre-step observe, ctrl load or tanh-MLP policy
// (weights staged once per block in shared memory), the emitted mj_step
// (oxc_step, from ops/scalar_graph.py through ops/emit.py), reward, time
// limit, divergence test, masked auto-reset with Philox noise, and the
// trajectory rows stored to global memory.
//
// What bounds it: compute.  One cheetah env-step is ~1e5 scalar f32
// lane-ops (the emitter counts them exactly) against a few hundred bytes
// of state and ctrl, so the kernel is far above the card's ridge point;
// square roots, logs, cosines, tanh and divisions add a second bound at
// the special-function rate.  The design keeps all of it in registers
// (spilling to L1-resident local memory where the step body needs more),
// reads the weights from shared memory by broadcast, and touches device
// memory only for the per-step ctrl and trajectory rows.  With one thread
// per env a batch of 4096 fills 128 warps: one per SM, a quarter of the
// issue slots -- the first thing a faster version changes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rollout.cuh"
#include "oxc_model.h"

#define OXC_NA_ROWS 1
// one warp per block: a batch of 4096 spreads over 128 SMs
#define OXC_BLOCK 32

struct OxcMlp {
  int n_layers;
  int dims[OXC_MAX_LAYERS + 1];
};

__global__ void __launch_bounds__(OXC_BLOCK)
oxc_rollout_kernel(const float* __restrict__ qpos,
                   const float* __restrict__ qvel,
                   const float* __restrict__ act,
                   const float* __restrict__ ws,
                   const float* __restrict__ time_in,
                   const float* __restrict__ ctrl,
                   const int* __restrict__ seed_ptr,
                   const float* __restrict__ params, int n_params,
                   OxcMlp mlp, float explore_sigma,
                   float* __restrict__ qpos_o, float* __restrict__ qvel_o,
                   float* __restrict__ act_o, float* __restrict__ ws_o,
                   float* __restrict__ time_o,
                   float* __restrict__ reward_sum,
                   float* __restrict__ diverged,
                   float* __restrict__ obs_o, float* __restrict__ rewards_o,
                   float* __restrict__ dones_o, float* __restrict__ ctrls_o,
                   int B, int K) {
  extern __shared__ float sh_params[];
  const bool policy = params != nullptr;
  if (policy) {
    for (int i = threadIdx.x; i < n_params; i += blockDim.x)
      sh_params[i] = params[i];
    __syncthreads();
  }
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  const bool collect = obs_o != nullptr;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  float q[OXC_NQ], v[OXC_NV], w[OXC_NV];
  for (int i = 0; i < OXC_NQ; ++i) q[i] = qpos[i * B + env];
  for (int i = 0; i < OXC_NV; ++i) v[i] = qvel[i * B + env];
  for (int i = 0; i < OXC_NV; ++i) w[i] = ws[i * B + env];
  // exact step counter (time is always a multiple of h here)
  int n = (int)rintf(time_in[env] * OXC_INV_H);
  float rew = 0.0f, ndiv = 0.0f;

  for (int k = 0; k < K; ++k) {
    float c[OXC_NU];
    if (policy || collect) {
      float obs[OXC_NOBS];
      oxc_observe(q, v, obs);
      if (collect)
        for (int i = 0; i < OXC_NOBS; ++i)
          obs_o[((size_t)k * OXC_NOBS + i) * B + env] = obs[i];
      if (policy) {
        oxc_mlp(sh_params, mlp.n_layers, mlp.dims, obs, c);
        if (explore_sigma > 0.0f) {
          float s[2 * OXC_NU];
          oxc_draw_signed(seed, OXC_SALT_EXPLORE, (uint32_t)env, (uint32_t)k,
                          2 * OXC_NU, s);
          for (int u = 0; u < OXC_NU; ++u)
            c[u] = c[u] + explore_sigma * oxc_box_muller(s[u], s[OXC_NU + u]);
        }
        if (collect)
          for (int u = 0; u < OXC_NU; ++u)
            ctrls_o[((size_t)k * OXC_NU + u) * B + env] = c[u];
      }
    }
    if (!policy)
      for (int u = 0; u < OXC_NU; ++u)
        c[u] = ctrl[((size_t)k * OXC_NU + u) * B + env];

    float qn[OXC_NQ], vn[OXC_NV], wn[OXC_NV];
    oxc_step(q, v, w, c, qn, vn, wn);
    n += 1;

    // divergence (non-finite or |x| > 1e10) + time limit; bad is known
    // before the reward so a diverged step's reward is masked to 0
    bool bad = false;
    for (int i = 0; i < OXC_NQ; ++i)
      bad = bad || !oxc_isfinite(qn[i]) || fabsf(qn[i]) > 1e10f;
    for (int i = 0; i < OXC_NV; ++i)
      bad = bad || !oxc_isfinite(vn[i]) || fabsf(vn[i]) > 1e10f;
    const bool done = bad || n >= OXC_LIMIT_N;
    ndiv += bad ? 1.0f : 0.0f;
    const float r = bad ? 0.0f : oxc_reward(qn, vn, c);
    rew += r;
    if (collect) {
      rewards_o[(size_t)k * B + env] = r;
      dones_o[(size_t)k * B + env] = done ? 1.0f : 0.0f;
    }

    for (int i = 0; i < OXC_NQ; ++i) q[i] = qn[i];
    for (int i = 0; i < OXC_NV; ++i) v[i] = vn[i];
    for (int i = 0; i < OXC_NV; ++i) w[i] = wn[i];
    if (done) {
      // masked auto-reset: nq uniforms + (nq + nv) Box-Muller normals
      float s[OXC_NDRAW], z[OXC_NQ + OXC_NV];
      oxc_draw_signed(seed, OXC_SALT_RESET, (uint32_t)env, (uint32_t)k,
                      OXC_NDRAW, s);
      for (int i = 0; i < OXC_NQ + OXC_NV; ++i)
        z[i] = oxc_box_muller(s[OXC_NQ + i], s[2 * OXC_NQ + OXC_NV + i]);
      oxc_reset(s, z, q, v);
      for (int i = 0; i < OXC_NV; ++i) w[i] = 0.0f;
      n = 0;
    }
  }

  for (int i = 0; i < OXC_NQ; ++i) qpos_o[i * B + env] = q[i];
  for (int i = 0; i < OXC_NV; ++i) qvel_o[i * B + env] = v[i];
  for (int i = 0; i < OXC_NV; ++i) ws_o[i * B + env] = w[i];
  // na == 0 in the kernel class: the one act row passes through
  for (int i = 0; i < OXC_NA_ROWS; ++i) act_o[i * B + env] = act[i * B + env];
  time_o[env] = (float)n * OXC_H;
  reward_sum[env] = rew;
  diverged[env] = ndiv;
}

extern "C" int oxc_rollout_launch(
    const float* qpos, const float* qvel, const float* act, const float* ws,
    const float* time_in, const float* ctrl, const int* seed,
    const float* params, int n_params, int n_layers, const int* dims,
    float explore_sigma, float* qpos_o, float* qvel_o, float* act_o,
    float* ws_o, float* time_o, float* reward_sum, float* diverged,
    float* obs_o, float* rewards_o, float* dones_o, float* ctrls_o, int B,
    int K, void* stream) {
  OxcMlp mlp;
  mlp.n_layers = n_layers;
  for (int i = 0; i <= OXC_MAX_LAYERS; ++i) mlp.dims[i] = dims[i];
  if (n_layers > OXC_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= n_layers; ++i)
    if (dims[i] > OXC_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (params && (dims[0] != OXC_NOBS || dims[n_layers] != OXC_NU))
    return (int)cudaErrorInvalidValue;
  const int threads = OXC_BLOCK;
  const int blocks = (B + threads - 1) / threads;
  const size_t shmem = params ? (size_t)n_params * sizeof(float) : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        oxc_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  oxc_rollout_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      qpos, qvel, act, ws, time_in, ctrl, seed, params, n_params, mlp,
      explore_sigma, qpos_o, qvel_o, act_o, ws_o, time_o, reward_sum,
      diverged, obs_o, rewards_o, dones_o, ctrls_o, B, K);
  return (int)cudaGetLastError();
}

extern "C" const char* oxc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
