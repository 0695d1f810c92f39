"""Rollouts: K lockstep env steps per call, on the general path or in the
rollout kernel, on one GPU or sharded over the env axis.

The port of ``oxide_control_tpu/parallel/rollout.py``.  ``rollout`` runs K
steps of ``BatchedEnvironment.step`` eagerly; ``jit_rollout`` is its
analog of ``jax.jit`` with donated state: on the card it captures one
step (policy, physics, task, auto-reset) in a ``torch.cuda.CUDAGraph``
over static state buffers and replays it K times per call.
``FastRollout`` packs the batch into the kernel's coordinate-major state
and runs ``ops.megakernel.build_rollout`` once per call, with actions
either drawn uniformly on the device (outside the kernel) or produced by
an in-kernel ``MLPPolicy``.  Per call it also takes the mocap poses, the
eq_active rows and, with ``applied_forces``, the applied forces of every
env.

Each takes ``mesh=`` (``parallel.mesh.make_env_mesh``): one process per
device, each holding its rows ``[lo, hi)`` of the batch.  The sharded
``rollout`` computes the unsharded one (its random draws are the whole
batch's, of which each rank keeps its rows, as the reference's sharded
``jax.random`` draws are); the sharded ``FastRollout`` gives each rank
its own ctrl and seed stream, the analog of the reference's
``fold_in(rng, axis_index)``.  The consumer reduction, the mean return
over every env, is an ``all_reduce`` of the ranks' sums.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .. import convert
from ..api.environment import BatchedEnvironment
from ..ops import megakernel as mk
from ..ops import scalar_graph as sg
from ..state import Data, make_data, mocap_rest_pose, tree_map
from .mesh import EnvMesh, env_sharding, fold_in, shard_env_state


class ShardedEnvironment(BatchedEnvironment):
    """This rank's rows ``[lo, hi)`` of ``benv``'s batch, on the mesh's
    device.  It steps those rows only; its episodes (a reset, an
    auto-reset) are drawn for the whole batch from the caller's generator
    and cut to its rows, so the union of the shards is the unsharded
    batch bit for bit.  That costs each rank the whole batch's
    ``init_episode`` draws at every step (``forward`` runs on its rows)."""

    def __init__(self, benv: BatchedEnvironment, mesh: EnvMesh):
        if benv.device != mesh.device:
            raise ValueError(f"the batch lives on {benv.device}, the mesh "
                             f"on {mesh.device}")
        self.lo, self.hi = env_sharding(mesh, benv.num_envs)
        super().__init__(benv.model, benv.task, self.hi - self.lo,
                         device=mesh.device, dtype=benv.dtype,
                         auto_reset=benv.auto_reset)
        self.mesh = mesh
        self.whole = benv

    def _episode(self, generator: torch.Generator) -> Data:
        return shard_env_state(self.mesh, self.whole._episode(generator))


def uniform_policy(benv: BatchedEnvironment):
    """The default policy: actions uniform in [-1, 1), drawn from the
    caller's generator (for a :class:`ShardedEnvironment`, the whole
    batch's actions, cut to its rows)."""
    rows = slice(None)
    n = benv.num_envs
    if isinstance(benv, ShardedEnvironment):
        rows, n = slice(benv.lo, benv.hi), benv.whole.num_envs
    shape = (n, benv.model.nu)

    def policy(generator, obs):
        a = torch.empty(shape, dtype=benv.dtype, device=benv.device)
        return a.uniform_(-1.0, 1.0, generator=generator)[rows]

    return policy


def mean_return(returns: torch.Tensor, mesh: EnvMesh | None = None):
    """The consumer reduction: the mean of the per-env returns ``(B,)``.
    With a mesh, ``returns`` holds this rank's envs: the ranks' sums are
    all-reduced over the mesh's group and divided by the whole batch, the
    same float on every rank."""
    if mesh is None:
        return returns.mean()
    total = returns.sum()
    dist.all_reduce(total, group=mesh.group)
    return total / (returns.shape[0] * mesh.world_size)


def _steps(benv, data, generator, num_steps, policy):
    obs = benv.observe(data)
    rewards, dones = [], []
    for _ in range(num_steps):
        data, ts = benv.step(data, policy(generator, obs), generator)
        obs = ts.observation
        rewards.append(ts.reward)
        dones.append(ts.done)
    return data, torch.stack(rewards), torch.stack(dones)


def rollout(benv: BatchedEnvironment, data: Data,
            generator: torch.Generator, num_steps: int, policy=None,
            mesh: EnvMesh | None = None):
    """``num_steps`` lockstep steps of ``benv.step`` -> ``(final_data,
    (rewards (K, B), dones (K, B)), mean_return)``.  ``policy(generator,
    obs) -> action (B, nu)`` defaults to uniform actions in [-1, 1).

    With ``mesh``, ``data`` is this rank's shard of ``benv``'s batch
    (``mesh.shard_env_state``) and the rollout runs on its rows
    (:class:`ShardedEnvironment`; a given policy sees those rows'
    observations); the final data, rewards and dones are this rank's,
    ``mean_return`` is the whole batch's (:func:`mean_return`)."""
    if mesh is not None:
        benv = ShardedEnvironment(benv, mesh)
    data, rewards, dones = _steps(benv, data, generator, num_steps,
                                  policy or uniform_policy(benv))
    return data, (rewards, dones), mean_return(rewards.sum(0), mesh)


class JitRollout:
    """``rollout`` with the state donated: each call consumes ``data`` and
    returns the new state.  On a CUDA batch the first call warms one step
    up eagerly (on a copy of the state, the generator restored after it)
    and captures the step in a CUDA graph, the generator registered with
    the graph; every call then copies ``data`` into the graph's static
    state, replays the step K times and returns the static state (valid
    until the next call).  A graph draws from the one generator it was
    captured with, so a call with another generator captures the step
    again for that one.  On the CPU every call runs ``rollout``.  With
    ``mesh`` the calls take and return this rank's shard, as ``rollout``
    does, and the mean return is all-reduced after the replays."""

    def __init__(self, benv: BatchedEnvironment, num_steps: int,
                 policy=None, mesh: EnvMesh | None = None):
        self.mesh = mesh
        if mesh is not None:
            benv = ShardedEnvironment(benv, mesh)
        self.benv = benv
        self.num_steps = num_steps
        self.policy = policy or uniform_policy(benv)
        self.graph = None
        self.generator = None
        self.capture_s = None

    def _body(self, generator):
        st = self._static
        action = self.policy(generator, st["obs"])
        data, ts = self.benv.step(st["data"], action, generator)
        tree_map(lambda dst, src: dst.copy_(src), st["data"], data)
        st["obs"].copy_(ts.observation)
        st["reward"].copy_(ts.reward)
        st["done"].copy_(ts.done)

    def _capture(self, data, generator):
        t0 = time.perf_counter()
        self._static = {
            "data": tree_map(lambda x: x.clone(), data),
            "obs": self.benv.observe(data).clone(),
            "reward": torch.zeros_like(data.time),
            "done": torch.zeros_like(data.time, dtype=torch.bool),
        }
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this torch's CUDAGraph cannot register a generator "
                f"(torch {torch.__version__}): jit_rollout needs it")
        graph.register_generator_state(generator)
        saved = tree_map(lambda x: x.clone(), self._static["data"])
        gstate = generator.get_state()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body(generator)
        torch.cuda.current_stream().wait_stream(side)
        tree_map(lambda dst, src: dst.copy_(src), self._static["data"], saved)
        generator.set_state(gstate)
        with torch.cuda.graph(graph):
            self._body(generator)
        torch.cuda.synchronize()
        self.graph = graph
        self.generator = generator
        self.capture_s = time.perf_counter() - t0

    def __call__(self, data: Data, generator: torch.Generator):
        if data.qpos.device.type != "cuda":
            data, rewards, dones = _steps(self.benv, data, generator,
                                          self.num_steps, self.policy)
            return (data, (rewards, dones),
                    mean_return(rewards.sum(0), self.mesh))
        if self.graph is None or generator is not self.generator:
            self._capture(data, generator)
        st = self._static
        if data is not st["data"]:
            tree_map(lambda dst, src: dst.copy_(src), st["data"], data)
            st["obs"].copy_(self.benv.observe(data))
        k = self.num_steps
        rewards = torch.empty((k,) + st["reward"].shape,
                              dtype=st["reward"].dtype,
                              device=data.qpos.device)
        dones = torch.empty((k,) + st["done"].shape, dtype=torch.bool,
                            device=data.qpos.device)
        for i in range(k):
            self.graph.replay()
            rewards[i].copy_(st["reward"])
            dones[i].copy_(st["done"])
        return (st["data"], (rewards, dones),
                mean_return(rewards.sum(0), self.mesh))


def jit_rollout(benv: BatchedEnvironment, num_steps: int, policy=None,
                mesh: EnvMesh | None = None):
    """A :class:`JitRollout` of ``num_steps`` steps (the analog of
    ``jax.jit(rollout)`` with donated state)."""
    return JitRollout(benv, num_steps, policy, mesh)


def unsupported_reason(benv: BatchedEnvironment) -> str | None:
    """Why (model, task) cannot run in the rollout kernel (None if they
    can): the model must be in the port's scalar-graph class, the task
    must have in-kernel hooks, and a task that observes sensors needs
    every sensor in the kernel family."""
    reason = sg.unsupported_reason(benv.model)
    if reason is not None:
        return reason
    if not hasattr(benv.task, "kernel_hooks"):
        return "the task has no kernel_hooks"
    if benv.task.kernel_hooks(benv.model).needs_sensors:
        reason = sg.unsupported_sensor_reason(benv.model)
        if reason is not None:
            return f"the task observes sensors: {reason}"
    return None


def fast_rollout_supported(benv: BatchedEnvironment) -> bool:
    """True if (model, task) qualify for the rollout kernel (see
    :func:`unsupported_reason`)."""
    return unsupported_reason(benv) is None


class Trajectory:
    """Per-call rollout outputs (struct of tensors, time-major).

    Always: ``reward_sum (B,)`` (per-env sum over the K steps) and
    ``diverged (B,)`` (divergence-triggered auto-resets).  A diverged step
    contributes reward 0 and sets the done flag.  With ``collect=True``:
    ``obs (K, n_obs, B)`` (the pre-step observation the policy acted on),
    ``rewards (K, B)``, ``dones (K, B)`` and, with an in-kernel policy,
    ``ctrls (K, nu, B)``.  Under a mesh every tensor holds this rank's
    envs only (B is the rank's ``hi - lo``); ``FastRollout.mean_return``
    reduces over the whole batch.
    """

    def __init__(self, reward_sum, diverged, obs=None, rewards=None,
                 dones=None, ctrls=None):
        self.reward_sum = reward_sum
        self.diverged = diverged
        self.obs = obs
        self.rewards = rewards
        self.dones = dones
        self.ctrls = ctrls


class FastRollout:
    """K environment steps per call, all inside one kernel launch on the
    batch's device (a CPU batch runs the kernel's plain version).

    Usage::

        roll = FastRollout(benv, steps_per_call=200, policy=pol,
                           collect=True)
        gen = torch.Generator(device=benv.device).manual_seed(0)
        state = roll.init(gen)
        state, traj = roll.run(state, gen)

    ``applied_forces=True`` builds the kernel that takes per-env
    ``qfrc_applied``/``xfrc_applied`` at each call (push randomization).

    ``mesh`` (``parallel.mesh.make_env_mesh``) shards the batch of B envs
    over the mesh's ranks: the kernel is built for this rank's ``B /
    world`` envs, the state and the trajectory hold its columns ``[lo,
    hi)``, and each call draws its ctrl and seed from this rank's stream of
    the caller's generator (``mesh.fold_in``).  The policy's weights are
    replicated: each call broadcasts them from the mesh's rank 0.
    """

    def __init__(self, benv: BatchedEnvironment, steps_per_call: int,
                 policy=None, collect: bool = False,
                 applied_forces: bool = False, mesh: EnvMesh | None = None):
        reason = unsupported_reason(benv)
        if reason is not None:
            # the caller chooses the general path (jit_rollout), as the
            # reference leaves that choice to fast_rollout_supported's caller
            raise ValueError(f"model/task not kernel-eligible: {reason}; "
                             "use jit_rollout for the general path")
        if mesh is not None and benv.device != mesh.device:
            raise ValueError(f"the batch lives on {benv.device}, the mesh "
                             f"on {mesh.device}")
        model = benv.model
        self.benv = benv
        self.device = benv.device
        self.steps_per_call = steps_per_call
        self.policy = policy
        self.collect = collect
        self.mesh = mesh
        self.lo, self.hi = ((0, benv.num_envs) if mesh is None
                            else env_sharding(mesh, benv.num_envs))
        hooks = benv.task.kernel_hooks(model)
        self.n_obs = hooks.n_obs
        self.applied_forces = bool(applied_forces)
        self.kernel = mk.build_rollout(
            model, self.hi - self.lo, steps_per_call, hooks,
            emit_obs=collect, policy=policy, applied_forces=applied_forces,
        )
        # the mocap bodies' rest poses (body_pos, body_quat), in mocap order
        self._mocap_rest = tuple(torch.as_tensor(a, device=self.device)
                                 for a in mocap_rest_pose(model))
        # an accelerometer-family sensor observation carries the previous
        # step's stage-1 qacc as a sixth state element
        self._carry_qacc = self.kernel.spec.carry_qacc
        self._n_state = self.kernel.n_state

    def init(self, generator: torch.Generator):
        """Batched reset -> coordinate-major kernel state.  Under a mesh
        every rank resets all B envs from ``generator`` and keeps its
        columns, so the shards together are the unsharded reset."""
        data = self.benv.reset(generator)
        if self.mesh is not None:
            data = shard_env_state(self.mesh, data)
        return self.pack(data)

    def pack(self, data: Data):
        """Env-major Data -> kernel state ``(qpos (nq,B), qvel (nv,B),
        act (max(na,1),B), warmstart (nv,B), time (1,B)[, qacc (nv,B)])``;
        na == 0 models carry one zero act row, and a task that observes an
        accelerometer-family sensor carries ``data.qacc``."""
        b = data.qpos.shape[0]
        act = data.act.T
        if act.shape[0] == 0:
            act = torch.zeros((1, b), dtype=data.qpos.dtype,
                              device=data.qpos.device)
        state = (data.qpos.T, data.qvel.T, act, data.qacc_warmstart.T,
                 data.time[None, :])
        if self._carry_qacc:
            state += (data.qacc.T,)
        return tuple(x.contiguous() for x in state)

    def unpack(self, state) -> Data:
        """Kernel state -> env-major Data with its core fields filled (the
        inverse of :meth:`pack`; derived fields zero), for a checkpoint."""
        data = make_data(self.benv.model, state[0].device, state[0].dtype,
                         batch=state[0].shape[1])
        data = data.replace(
            qpos=state[0].T, qvel=state[1].T,
            act=state[2].T[:, :self.benv.model.na],
            qacc_warmstart=state[3].T, time=state[4][0])
        if self._carry_qacc:
            data = data.replace(qacc=state[5].T)
        return data

    def _broadcast_policy(self):
        """The policy's weights from the mesh's rank 0 to every rank, in
        place (one flat broadcast)."""
        params = list(self.policy.parameters())
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in params])
            dist.broadcast(flat, src=self.mesh.global_rank(0),
                           group=self.mesh.group)
            i = 0
            for p in params:
                p.copy_(flat[i:i + p.numel()].view_as(p))
                i += p.numel()

    def run(self, state, generator: torch.Generator, eq_active=None, *,
            mocap_pos=None, mocap_quat=None, qfrc_applied=None,
            xfrc_applied=None):
        """One K-step kernel call -> ``(new_state, Trajectory)``.  The
        policy's current weights are the call's inputs.  A model with
        equality constraints takes ``eq_active (B, neq)``, 0/1 per env and
        equality (Data.eq_active; default the model's eq_active0); a model
        with mocap bodies takes ``mocap_pos (B, nmocap, 3)`` and
        ``mocap_quat (B, nmocap, 4)`` (default the rest pose); with
        ``applied_forces`` the call takes ``qfrc_applied (B, nv)`` and
        ``xfrc_applied (B, nbody, 6)`` (default zero).  Every one is
        constant over the K steps.  Each raises where the model or the
        build does not take it: for mocap poses on a model without mocap
        bodies the reference crashes instead (its default pose is None).
        Under a mesh these per-env inputs are the whole batch's (B rows);
        each rank keeps its rows, as its state holds its columns."""
        model = self.benv.model
        b = self.benv.num_envs
        lo, hi = self.lo, self.hi
        dtype = state[0].dtype
        if model.nmocap == 0 and (mocap_pos is not None
                                  or mocap_quat is not None):
            raise ValueError("mocap_pos/mocap_quat given for a model "
                             "without mocap bodies")
        if not self.applied_forces and (qfrc_applied is not None
                                        or xfrc_applied is not None):
            raise ValueError("pass applied_forces=True to FastRollout to "
                             "use qfrc_applied/xfrc_applied")

        def rows(x, default, shape):
            x = default.expand(shape) if x is None else torch.as_tensor(
                x, device=self.device)
            if tuple(x.shape) != shape:
                raise ValueError(f"want shape {shape}, not "
                                 f"{tuple(x.shape)}")
            return x[lo:hi].to(dtype)

        mocap = qfrc = xfrc = None
        if model.nmocap:
            pos0, quat0 = self._mocap_rest
            mocap = convert.mocap_to_kernel(
                rows(mocap_pos, pos0, (b, model.nmocap, 3)),
                rows(mocap_quat, quat0, (b, model.nmocap, 4)), dtype)
        if self.applied_forces:
            zero = torch.zeros((), dtype=dtype, device=self.device)
            qfrc = rows(qfrc_applied, zero, (b, model.nv)).T.contiguous()
            xfrc = convert.xfrc_to_kernel(
                rows(xfrc_applied, zero, (b, model.nbody, 6)), dtype)
        if model.neq == 0 and eq_active is not None:
            raise ValueError("eq_active given for a model without equality "
                             "constraints")
        if model.neq:
            if eq_active is None:
                eq_active = torch.tensor(
                    [float(x) for x in model.eq_active0], dtype=dtype,
                    device=self.device).expand(b, -1)
            if tuple(eq_active.shape) != (b, model.neq):
                raise ValueError(f"eq_active must have shape "
                                 f"{(b, model.neq)}, not "
                                 f"{tuple(eq_active.shape)}")
            eq_active = convert.eq_active_to_kernel(eq_active[lo:hi], dtype,
                                                    self.device)
        if self.mesh is not None:
            generator = fold_in(generator, self.mesh.rank)
        ctrl = params = None
        if self.policy is None:
            ctrl = torch.empty((self.steps_per_call, max(model.nu, 1),
                                hi - lo), dtype=dtype, device=self.device)
            ctrl.uniform_(-1.0, 1.0, generator=generator)
        else:
            if self.mesh is not None:
                self._broadcast_policy()
            params = self.policy.kernel_params()
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=self.device, dtype=torch.int32)
        out = self.kernel(*state, ctrl, seed, params, eq_active,
                          mocap=mocap, qfrc=qfrc, xfrc=xfrc)
        ns = self._n_state
        traj = Trajectory(reward_sum=out[ns][0], diverged=out[ns + 1][0])
        if self.collect:
            traj.obs, traj.rewards, traj.dones = out[ns + 2:ns + 5]
            if self.policy is not None:
                traj.ctrls = out[ns + 5]
        return tuple(out[:ns]), traj

    def mean_return(self, traj: Trajectory):
        """The mean of ``traj.reward_sum`` over every env of the batch
        (all-reduced over the mesh: see :func:`mean_return`)."""
        return mean_return(traj.reward_sum, self.mesh)
