// K-step rollout kernel for Hopper (sm_90a): the hand-written shell.
//
// Replaces the TPU kernel oxide_control_tpu/ops/megakernel.py:build_rollout
// (one pl.pallas_call holding the whole engine).  A team of OXC_TEAM = G
// lanes of one warp runs one env (G = 1, 2, 4 or 8, a constant of the
// model's emitted header) over the coordinate-major (rows, B) layout, so
// every load and store of a state row or trajectory row is coalesced across
// the warp.  The team keeps its env's state in registers for all K steps
// (every lane holds it whole): the loop inside the
// kernel takes the place of the TPU kernel's sequential chunk grid and its
// VMEM carry (q, v, act and the Newton warmstart).  Per step: pre-step
// observe, ctrl load or tanh-MLP policy (one lane per env: the weights
// staged once per block in shared memory; a team: read through L1), the
// emitted mj_step (oxc_step, from ops/scalar_graph.py through
// ops/emit.py), reward, time limit, divergence test, masked
// auto-reset with Philox noise, and the trajectory rows stored to global
// memory, by the team's first lane.  Every per-env array is sized by the
// OXC_* macros of the model's
// emitted header (oxc_model.h), so one shell serves every model of the
// class.  A task that observes sensors (OXC_NSENSORDATA) has them computed
// inside oxc_observe at the pre-step state; the clock reads n * h, and the
// accelerometer family (OXC_CARRY_QACC) reads the previous step's stage-1
// qacc, which the thread carries in registers beside q and v, zeroes on
// reset and stores at the end.  The inputs that are constant over a call
// -- mocap poses (OXC_NMOCAP) and applied forces (OXC_APPLIED) -- stay in
// global memory: the step gets a pointer into the env's column and reads
// each value where it is used (element i at i * B), since the cheetah
// class already fills the 255 registers a thread may have.
//
// The team.  Every lane of a team runs the env's serial code on the same
// inputs -- FK, dynamics, Cholesky, narrowphase, the constraint rows,
// Newton's gradient, Hessian and direction, the env layer and the Philox
// draws (keyed on env and step) -- so the lanes hold the same bits without
// talking.  Two parts are split: the line search's dphi sums over the
// constraint rows, each lane summing its slots and the team adding its G
// partials with __shfl_xor_sync (emitted into oxc_step, see
// ops/scalar_graph.py:_linesearch_scalar), and the MLP, each lane
// computing every G-th output of a layer (oxc_mlp_team).  The sums are
// taken in one fixed order, which the plain version follows, so the two
// agree bit for bit at every G.  The shuffles use the team's lane mask:
// teams of one warp may part at a reset, and a team whose env is past B
// returns whole.  The redundant serial work takes issue slots that one
// thread per env leaves idle (one warp per SM at B = 4096).
//
// What bounds it: compute.  One env-step is ~1e4 (cartpole, four RK4
// passes) to ~4e5 (humanoid) scalar f32 lane-ops (the emitter counts them
// exactly) against a few hundred bytes of state and ctrl, so the kernel is
// far above the card's ridge point;
// square roots, logs, cosines, tanh and divisions add a second bound at
// the special-function rate.  The design keeps all of it in registers
// (spilling to L1-resident local memory where the step body needs more),
// reads the weights from shared memory by broadcast, and touches device
// memory only for the per-step ctrl and trajectory rows.  With one thread
// per env a batch of 4096 fills 128 warps: one per SM, a quarter of the
// issue slots; a team of G fills G times as many.  Each lane of a team
// keeps the env's whole stack frame in local memory (some 2 KB where the
// body spills), so G multiplies the SM's L1 footprint too: the team size
// of a model (ops/megakernel.py:team_rule) is the one that pays, from a
// sweep of G on the card (tools/team_sweep.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rollout.cuh"
#include "oxc_model.h"

// the act input and output hold max(na, 1) rows: a model without
// activation state carries one row, passed through
#define OXC_NA_ROWS (OXC_NA > 0 ? OXC_NA : 1)
// a model without actuators (nu = 0) still sizes its ctrl buffers at 1
#define OXC_NU_ROWS (OXC_NU > 0 ? OXC_NU : 1)
#ifndef OXC_TEAM
#define OXC_TEAM 1
#endif
// one warp per block: the envs spread most evenly over the SMs.  (With
// __launch_bounds__(128) ptxas gave the humanoid's and the cable's team
// bodies 32 registers and 9-18 KB stacks: 2-2.4x slower than at 32.)
#define OXC_BLOCK 32
#if OXC_TEAM > 1
// a team's MLP activations take a stride of 2 * OXC_MAX_WIDTH + G floats
// of shared memory, so the teams of a warp read and write different banks
#define OXC_XS_STRIDE (2 * OXC_MAX_WIDTH + OXC_TEAM)
#define OXC_TEAM_ARG , tl, tm
#else
#define OXC_TEAM_ARG
#endif
// equality constraints of the model (its header defines OXC_NEQ when it
// has any); their eq_active lanes are a runtime input
#ifndef OXC_NEQ
#define OXC_NEQ 0
#endif
#if OXC_NEQ > 0
#define OXC_EQ_ARG eqa,
#else
#define OXC_EQ_ARG
#endif
// sensors the observation reads, and whether one of them reads qacc (the
// header defines these only for a task that observes sensors)
#ifndef OXC_NSENSORDATA
#define OXC_NSENSORDATA 0
#endif
#ifndef OXC_CARRY_QACC
#define OXC_CARRY_QACC 0
#endif
#if OXC_CARRY_QACC
#define OXC_QA_OUT , qan
#else
#define OXC_QA_OUT
#endif
// call inputs read from the env's column of global memory (the header
// defines OXC_NMOCAP for a model with mocap bodies, OXC_APPLIED for a
// rollout built with applied forces, and OXC_OBS_MOCAP/OXC_REW_MOCAP for
// hooks that read the mocap poses through the FK or the sensors)
#ifndef OXC_NMOCAP
#define OXC_NMOCAP 0
#endif
#ifndef OXC_APPLIED
#define OXC_APPLIED 0
#endif
#if OXC_NMOCAP > 0
#define OXC_MC_ARG mcp,
#else
#define OXC_MC_ARG
#endif
#if OXC_APPLIED
#define OXC_FRC_ARG qfp, xfp,
#else
#define OXC_FRC_ARG
#endif
#if OXC_NMOCAP > 0 || OXC_APPLIED
#define OXC_LD_ARG B,
#else
#define OXC_LD_ARG
#endif
#ifdef OXC_OBS_MOCAP
#define OXC_OBS_MC_ARG mcp, B,
#else
#define OXC_OBS_MC_ARG
#endif
#ifdef OXC_REW_MOCAP
#define OXC_REW_MC_ARG , mcp, B
#else
#define OXC_REW_MC_ARG
#endif

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
                   const float* __restrict__ qacc_in,
                   const float* __restrict__ ctrl,
                   const int* __restrict__ seed_ptr,
                   const float* __restrict__ params, int n_params,
                   const float* __restrict__ mocap,
                   const float* __restrict__ eq_active,
                   const float* __restrict__ qfrc,
                   const float* __restrict__ xfrc,
                   OxcMlp mlp, float explore_sigma,
                   float* __restrict__ qpos_o, float* __restrict__ qvel_o,
                   float* __restrict__ act_o, float* __restrict__ ws_o,
                   float* __restrict__ time_o,
                   float* __restrict__ qacc_o,
                   float* __restrict__ reward_sum,
                   float* __restrict__ diverged,
                   float* __restrict__ obs_o, float* __restrict__ rewards_o,
                   float* __restrict__ dones_o, float* __restrict__ ctrls_o,
                   int B, int K) {
  extern __shared__ float sh_params[];
  const bool policy = params != nullptr;
#if OXC_TEAM > 1
  // the lane's index in its team, the team's lanes in the warp, and the
  // team's MLP activation buffer (the weights stay in global memory)
  const int tl = threadIdx.x % OXC_TEAM;
  const unsigned tm = ((1u << OXC_TEAM) - 1u)
                      << ((threadIdx.x & 31u) & ~(unsigned)(OXC_TEAM - 1));
  float* xs = sh_params + (threadIdx.x / OXC_TEAM) * OXC_XS_STRIDE;
  const int env = (blockIdx.x * blockDim.x + threadIdx.x) / OXC_TEAM;
  const bool lead = tl == 0;  // the lane that stores the env's rows
#else
  if (policy) {
    for (int i = threadIdx.x; i < n_params; i += blockDim.x)
      sh_params[i] = params[i];
    __syncthreads();
  }
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lead = true;
#endif
  if (env >= B) return;
  const bool collect = obs_o != nullptr;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  float q[OXC_NQ], v[OXC_NV], w[OXC_NV], a[OXC_NA_ROWS];
  for (int i = 0; i < OXC_NQ; ++i) q[i] = qpos[i * B + env];
  for (int i = 0; i < OXC_NV; ++i) v[i] = qvel[i * B + env];
  for (int i = 0; i < OXC_NA_ROWS; ++i) a[i] = act[i * B + env];
  for (int i = 0; i < OXC_NV; ++i) w[i] = ws[i * B + env];
#if OXC_CARRY_QACC
  float qa[OXC_NV];
  for (int i = 0; i < OXC_NV; ++i) qa[i] = qacc_in[i * B + env];
#endif
#if OXC_NEQ > 0
  // the env's eq_active lanes (0/1 per equality), constant over the call
  bool eqa[OXC_NEQ];
  for (int e = 0; e < OXC_NEQ; ++e)
    eqa[e] = eq_active[(size_t)e * B + env] != 0.0f;
#endif
#if OXC_NMOCAP > 0
  const float* mcp = mocap + env;  // the env's (7*nmocap, B) column
#endif
#if OXC_APPLIED
  const float* qfp = qfrc + env;   // (nv, B)
  const float* xfp = xfrc + env;   // (6*nbody, B)
#endif
  // exact step counter (time is always a multiple of h here)
  int n = (int)rintf(time_in[env] * OXC_INV_H);
  float rew = 0.0f, ndiv = 0.0f;

  for (int k = 0; k < K; ++k) {
    float c[OXC_NU_ROWS];
    if (policy || collect) {
      float obs[OXC_NOBS];
#if OXC_NSENSORDATA > 0
      const float clk = (float)n * OXC_H;
#if OXC_CARRY_QACC
      oxc_observe(q, v, qa, &clk, OXC_OBS_MC_ARG obs);
#else
      oxc_observe(q, v, nullptr, &clk, OXC_OBS_MC_ARG obs);
#endif
#else
      oxc_observe(q, v, OXC_OBS_MC_ARG obs);
#endif
      if (collect && lead)
        for (int i = 0; i < OXC_NOBS; ++i)
          obs_o[((size_t)k * OXC_NOBS + i) * B + env] = obs[i];
      if (policy) {
#if OXC_TEAM > 1
        __syncwarp(tm);  // the team is done with the last step's outputs
#pragma unroll
        for (int i = 0; i < OXC_NOBS; ++i)
          if (i % OXC_TEAM == tl) xs[i] = obs[i];
        const float* y = oxc_mlp_team<OXC_TEAM>(params, mlp.n_layers,
                                                mlp.dims, xs, tl, tm);
#pragma unroll
        for (int u = 0; u < OXC_NU; ++u) c[u] = y[u];
#else
        oxc_mlp(sh_params, mlp.n_layers, mlp.dims, obs, c);
#endif
        if (explore_sigma > 0.0f) {
          float s[2 * OXC_NU_ROWS];
          oxc_draw_signed(seed, OXC_SALT_EXPLORE, (uint32_t)env, (uint32_t)k,
                          2 * OXC_NU, s);
          for (int u = 0; u < OXC_NU; ++u)
            c[u] = c[u] + explore_sigma * oxc_box_muller(s[u], s[OXC_NU + u]);
        }
        if (collect && lead)
          for (int u = 0; u < OXC_NU; ++u)
            ctrls_o[((size_t)k * OXC_NU + u) * B + env] = c[u];
      }
    }
    if (!policy)
      for (int u = 0; u < OXC_NU; ++u)
        c[u] = ctrl[((size_t)k * OXC_NU + u) * B + env];

    float qn[OXC_NQ], vn[OXC_NV], wn[OXC_NV], an[OXC_NA_ROWS];
#if OXC_CARRY_QACC
    float qan[OXC_NV];
#endif
    oxc_step(q, v, a, w, c, OXC_EQ_ARG OXC_MC_ARG OXC_FRC_ARG OXC_LD_ARG qn,
             vn, an, wn OXC_QA_OUT OXC_TEAM_ARG);
    n += 1;

    // divergence (non-finite or |x| > 1e10, on q and v only) + time
    // limit; bad is known before the reward so a diverged step's reward is
    // masked to 0
    bool bad = false;
    for (int i = 0; i < OXC_NQ; ++i)
      bad = bad || !oxc_isfinite(qn[i]) || fabsf(qn[i]) > 1e10f;
    for (int i = 0; i < OXC_NV; ++i)
      bad = bad || !oxc_isfinite(vn[i]) || fabsf(vn[i]) > 1e10f;
    const bool done = bad || n >= OXC_LIMIT_N;
    ndiv += bad ? 1.0f : 0.0f;
    const float r = bad ? 0.0f : oxc_reward(qn, vn, c OXC_REW_MC_ARG);
    rew += r;
    if (collect && lead) {
      rewards_o[(size_t)k * B + env] = r;
      dones_o[(size_t)k * B + env] = done ? 1.0f : 0.0f;
    }

    for (int i = 0; i < OXC_NQ; ++i) q[i] = qn[i];
    for (int i = 0; i < OXC_NV; ++i) v[i] = vn[i];
    for (int i = 0; i < OXC_NV; ++i) w[i] = wn[i];
    for (int i = 0; i < OXC_NA; ++i) a[i] = an[i];
#if OXC_CARRY_QACC
    for (int i = 0; i < OXC_NV; ++i) qa[i] = qan[i];
#endif
    if (done) {
      // masked auto-reset: nq uniforms + (nq + nv) Box-Muller normals
      float s[OXC_NDRAW], z[OXC_NQ + OXC_NV];
      oxc_draw_signed(seed, OXC_SALT_RESET, (uint32_t)env, (uint32_t)k,
                      OXC_NDRAW, s);
      for (int i = 0; i < OXC_NQ + OXC_NV; ++i)
        z[i] = oxc_box_muller(s[OXC_NQ + i], s[2 * OXC_NQ + OXC_NV + i]);
      oxc_reset(s, z, q, v);
      for (int i = 0; i < OXC_NV; ++i) w[i] = 0.0f;
      for (int i = 0; i < OXC_NA; ++i) a[i] = 0.0f;
#if OXC_CARRY_QACC
      for (int i = 0; i < OXC_NV; ++i) qa[i] = 0.0f;
#endif
      n = 0;
    }
  }

  if (!lead) return;
  for (int i = 0; i < OXC_NQ; ++i) qpos_o[i * B + env] = q[i];
  for (int i = 0; i < OXC_NV; ++i) qvel_o[i * B + env] = v[i];
  for (int i = 0; i < OXC_NV; ++i) ws_o[i * B + env] = w[i];
  for (int i = 0; i < OXC_NA_ROWS; ++i) act_o[i * B + env] = a[i];
  time_o[env] = (float)n * OXC_H;
#if OXC_CARRY_QACC
  for (int i = 0; i < OXC_NV; ++i) qacc_o[i * B + env] = qa[i];
#endif
  reward_sum[env] = rew;
  diverged[env] = ndiv;
}

// The dynamic shared memory of a block -- the MLP's weights, or for a
// team each team's activation buffer -- with the kernel's shared-memory
// attributes set for it.  A team build without a policy asks for the
// largest L1, which holds the lanes' local memory (each lane of a team
// keeps the env's whole stack frame); with one it leaves the split to the
// CUDA runtime, which sizes the shared memory for the blocks an SM can
// hold (the largest L1 leaves room for one block's activation buffers).
static cudaError_t oxc_launch_shmem(bool policy, int n_params,
                                    size_t* shmem) {
  cudaError_t e = cudaSuccess;
#if OXC_TEAM > 1
  *shmem = policy ? (size_t)(OXC_BLOCK / OXC_TEAM) * OXC_XS_STRIDE
                        * sizeof(float)
                  : 0;
  e = cudaFuncSetAttribute(oxc_rollout_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           policy ? (int)cudaSharedmemCarveoutDefault
                                  : (int)cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return e;
#else
  *shmem = policy ? (size_t)n_params * sizeof(float) : 0;
#endif
  if (*shmem > 48 * 1024)
    e = cudaFuncSetAttribute(oxc_rollout_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*shmem);
  return e;
}

extern "C" int oxc_rollout_launch(
    const float* qpos, const float* qvel, const float* act, const float* ws,
    const float* time_in, const float* qacc_in, const float* ctrl,
    const int* seed,
    const float* params, int n_params, const float* mocap,
    const float* eq_active, const float* qfrc, const float* xfrc,
    int n_layers, const int* dims,
    float explore_sigma, float* qpos_o, float* qvel_o, float* act_o,
    float* ws_o, float* time_o, float* qacc_o, float* reward_sum,
    float* diverged,
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
  if (OXC_NEQ > 0 && eq_active == nullptr) return (int)cudaErrorInvalidValue;
  if (OXC_NMOCAP > 0 && mocap == nullptr) return (int)cudaErrorInvalidValue;
  if (OXC_APPLIED && (qfrc == nullptr || xfrc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (OXC_CARRY_QACC && (qacc_in == nullptr || qacc_o == nullptr))
    return (int)cudaErrorInvalidValue;
  size_t shmem = 0;
  cudaError_t e = oxc_launch_shmem(params != nullptr, n_params, &shmem);
  if (e != cudaSuccess) return (int)e;
  const int threads = OXC_BLOCK;
  const int blocks = (int)(((long long)B * OXC_TEAM + threads - 1) / threads);
  oxc_rollout_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      qpos, qvel, act, ws, time_in, qacc_in, ctrl, seed, params, n_params,
      mocap, eq_active, qfrc, xfrc, mlp, explore_sigma, qpos_o, qvel_o,
      act_o, ws_o, time_o, qacc_o, reward_sum, diverged, obs_o, rewards_o,
      dones_o, ctrls_o, B, K);
  return (int)cudaGetLastError();
}

// how many blocks of the kernel one SM holds with a call's shared memory
extern "C" int oxc_rollout_occupancy(int policy, int n_params,
                                     int* blocks_per_sm) {
  size_t shmem = 0;
  cudaError_t e = oxc_launch_shmem(policy != 0, n_params, &shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, oxc_rollout_kernel, OXC_BLOCK, shmem);
}

extern "C" const char* oxc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
