"""Traffic kind ``fast_rollout``: one caller in a closed loop over
``FastRollout.run``, the rollout kernel's entry point.

Each call is issued, then its mean return is read on the host before the
next call is issued, as a trainer that collects rollouts does.  The
traffic file sets the policy (``policy``: hidden sizes and exploration
sigma; null for ctrl drawn uniformly on the device by ``run``) and
whether the kernel stores the trajectory (``collect``).
"""

from __future__ import annotations

import torch

from .. import compare
from ..measure import clock
from ..reference.kernel_env import KernelCallReference, make_mlp_weights


class Driver:
    kind = "fast_rollout"

    def __init__(self, spec, seed: int, device, stages, spans,
                 sizes=None, start: int = 0):
        from oxide_control_torch import suite
        from oxide_control_torch.parallel.rollout import FastRollout
        from oxide_control_torch.policy import MLPPolicy
        stages.mark("import")

        config, traffic = spec.config, spec.traffic
        self.B, self.K = sizes or (config["batch"], spec.steps)
        self.spec, self.seed, self.device = spec, int(seed), device
        self.span = spans
        benv = suite.load_batched(config["domain"], config["task"], self.B,
                                  device=device,
                                  time_limit=config["time_limit_s"])
        stages.mark("model")
        pol = traffic["policy"]
        self.layers, self.sigma, policy = None, 0.0, None
        if pol is not None:
            dims = [config["n_obs"], *pol["hidden"], config["nu"]]
            self.layers = make_mlp_weights(seed, dims, device)
            self.sigma = float(pol["explore_sigma"])
            policy = MLPPolicy(config["n_obs"], config["nu"], pol["hidden"],
                               explore_sigma=self.sigma, device=device)
            with torch.no_grad():
                for layer, (w, b) in zip(policy.layers, self.layers):
                    layer.weight.copy_(w)
                    layer.bias.copy_(b)
        self.roll = FastRollout(benv, self.K, policy=policy,
                                collect=bool(traffic["collect"]))
        self.team = self.roll.kernel.team
        stages.mark("emission")
        self.gen = torch.Generator(device=device).manual_seed(
            2 * self.seed + 1)
        self.start_gen = self.gen.get_state()
        self.state = self.roll.init(self.gen)
        self.start_state = self.state
        # every episode starts ``start`` steps in, on the step counter
        self.state = self.state[:4] + (torch.full_like(
            self.state[4], start * float(config["timestep"])),) + \
            self.state[5:]
        stages.mark("reset")
        if torch.device(device).type == "cuda":
            self.roll.kernel.build()
        stages.mark("load")
        self.outputs = []   # (reward_sum, diverged) of every timed call
        self.samples = {}

    def warm(self, calls: int):
        """Calls that run before the window (the first launch included)."""
        for _ in range(calls):
            self.state, traj = self.roll.run(self.state, self.gen)
            float(self.roll.mean_return(traj))

    def call(self, keep: bool, index: int):
        """One timed call: (issued, returned, mean return on the host) on
        the host clock, with the benchmark's spans."""
        if keep:
            gen_state, inp = self.gen.get_state(), self.state
        t0 = clock()
        with self.span("bench.call"):
            self.state, traj = self.roll.run(self.state, self.gen)
        t1 = clock()
        with self.span("bench.read"):
            float(self.roll.mean_return(traj))
        t2 = clock()
        self.outputs.append((traj.reward_sum, traj.diverged))
        if keep:
            self.samples[index] = (inp, gen_state, self.state, traj)
        return t0, t1, t2

    def drop(self, index: int):
        self.samples.pop(index, None)

    def release(self):
        """Count the failed env-calls, then free the program's state."""
        failed = 0
        for reward_sum, diverged in self.outputs:
            bad = (diverged > 0) | ~torch.isfinite(reward_sum)
            failed += int(bad.sum())
        self.outputs = []
        del self.roll, self.state
        return failed

    # ----- the comparison with the reference ------------------------------

    def reference(self, device):
        return KernelCallReference(self.spec.config, self.B, self.K, device,
                                   self.layers, self.sigma)

    def judge(self, ref, limits: dict, control: bool = False):
        """The compared numbers of this run, and notes on the gaps.

        ``start_gap``: the reset against the reference's (largest
        relative gap of its state).  With stores, the reference follows
        the program step by step, each step started from the state the
        program stored: ``step_over_share`` is the share of the sampled
        calls' (step, env) pairs whose largest relative gap of a step's
        outputs (observation, reward, done) exceeds that number's
        ``over``, ``end_over_share`` the share of envs whose gap at the
        call's end (state, time, reward sum) does, and ``ctrl_gap`` the
        largest gap of a stored ctrl against the policy of the stored
        observation.  Without stores the reference runs freely from the
        call's input state, and ``env_over_share`` is the share of envs
        whose largest gap over the call's outputs exceeds its ``over``:
        the physics' chaos grows a rounding to a visible gap in a few
        envs, which the limit allows for.  ``control`` puts the reference
        in bfloat16 in the program's place."""
        gen = torch.Generator(device=ref.device)
        gen.set_state(self.start_gen)
        want = ref.init(gen)
        got = self.start_state
        if control:
            got = tuple(x.to(torch.bfloat16).to(x.dtype) for x in want)
        # the reset's answers: qpos, qvel, act and time (the warmstart is
        # the program's solver hint, which the reference has no use for)
        pick = lambda st: (st[0], st[1], st[2], st[4])  # noqa: E731
        out = {"start_gap": compare.rel_gap_max(pick(got), pick(want))}
        collect = bool(self.spec.traffic["collect"])
        gaps, ends, ctrl_gap = [], [], 0.0
        for index in sorted(self.samples):
            inp, gen_state, new, traj = self.samples[index]
            g = torch.Generator(device=ref.device)
            g.set_state(gen_state)
            ctrl = None
            if self.layers is None:
                ctrl = torch.empty((self.K, ref.model.nu, self.B),
                                   dtype=torch.float32, device=ref.device)
                ctrl.uniform_(-1.0, 1.0, generator=g)
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                                     device=ref.device,
                                     dtype=torch.int32)[0])
            if control:
                prog = ref.call(inp, seed, ctrl, lowp=True)
                if not collect:
                    prog = {k: prog[k] for k in compare.AT_END}
            else:
                prog = {"qpos": new[0], "qvel": new[1], "time": new[4],
                        "reward_sum": traj.reward_sum}
                if collect:
                    prog.update(obs=traj.obs, rewards=traj.rewards,
                                dones=traj.dones, ctrls=traj.ctrls)
            if self.layers is not None:
                ctrl_gap = max(ctrl_gap, compare.abs_gap_max(
                    prog["ctrls"], ref.ctrls_of(prog["obs"], seed)))
                ctrl = prog["ctrls"]
            if collect:
                want = ref.call(inp, seed, ctrl, forced=prog["obs"])
                gaps.append(compare.step_gaps(prog, want).flatten())
                ends.append(compare.end_gaps(prog, want))
            else:
                want = ref.call(inp, seed, ctrl)
                gaps.append(compare.env_gaps(prog, want))
        notes = {}
        if collect:
            gaps, ends = torch.cat(gaps), torch.cat(ends)
            out["step_over_share"] = compare.share_over(
                gaps, limits["step_over_share"]["over"])
            out["end_over_share"] = compare.share_over(
                ends, limits["end_over_share"]["over"])
            notes.update(compare.spread("step_gap", gaps),
                         **compare.spread("end_gap", ends))
        else:
            gaps = torch.cat(gaps)
            out["env_over_share"] = compare.share_over(
                gaps, limits["env_over_share"]["over"])
            notes.update(compare.spread("env_gap", gaps))
        if self.layers is not None:
            out["ctrl_gap"] = ctrl_gap
        return out, notes
