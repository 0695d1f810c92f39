"""Traffic kind ``jit_rollout``: one caller in a closed loop over
``jit_rollout``, the general path's entry point (a CUDA graph of one
``BatchedEnvironment.step`` replayed K times per call).

The policy is the caller's own torch code (:class:`NoisyMLP`: a tanh MLP
plus Gaussian noise from the caller's generator, run inside the captured
step), which keeps the observation it is handed at each step.  Each
call's mean return is read on the host before the next call.
"""

from __future__ import annotations

import torch

from .. import compare
from ..measure import clock
from ..reference.general import GeneralCallReference, NoisyMLP
from ..reference.kernel_env import make_mlp_weights
from ..reference.tasks import Task


CORE = ("qpos", "qvel", "qacc_warmstart", "time")


def core(data) -> dict:
    """A copy of the fields of the program's ``data`` that a call starts
    from (the reference solves each step afresh, so it reads the first
    three)."""
    return {f: getattr(data, f).clone() for f in CORE}


class Driver:
    kind = "jit_rollout"

    def __init__(self, spec, seed: int, device, stages, spans,
                 sizes=None, start: int = 0):
        from oxide_control_torch import suite
        from oxide_control_torch.parallel.rollout import jit_rollout
        stages.mark("import")

        config, traffic = spec.config, spec.traffic
        # the traffic's batch, where it names one, else the configuration's
        self.B, self.K = sizes or (int(traffic.get("batch",
                                                   config["batch"])),
                                   spec.steps)
        self.spec, self.seed, self.device = spec, int(seed), device
        self.span = spans
        self.benv = suite.load_batched(config["domain"], config["task"],
                                       self.B, device=device,
                                       time_limit=config["time_limit_s"])
        stages.mark("model")
        pol = traffic["policy"]
        dims = [config["n_obs"], *pol["hidden"], config["nu"]]
        self.layers = make_mlp_weights(seed, dims, device)
        self.sigma = float(pol["explore_sigma"])
        self.record = torch.zeros((self.K, self.B, config["n_obs"]),
                                  dtype=torch.float32, device=device)
        self.policy = NoisyMLP(self.layers, self.sigma, record=self.record)
        self.roll = jit_rollout(self.benv, self.K, policy=self.policy)
        self.gen = torch.Generator(device=device).manual_seed(
            2 * self.seed + 1)
        self.start_gen = self.gen.get_state()
        self.data = self.benv.reset(self.gen)
        self.start = core(self.data)
        # every episode starts ``start`` steps in, on the float32 clock
        self.data = self.data.replace(time=torch.full_like(
            self.data.time, start * float(config["timestep"])))
        stages.mark("reset")
        self.outputs = []
        self.samples = {}

    def warm(self, calls: int):
        """Calls that run before the window: the first warms one step up
        and captures it in a CUDA graph."""
        for _ in range(calls):
            self.policy.step.zero_()
            self.data, _, mean = self.roll(self.data, self.gen)
            float(mean)

    def call(self, keep: bool, index: int):
        if keep:
            gen_state = self.gen.get_state()
            inp = core(self.data)
        t0 = clock()
        with self.span("bench.call"):
            self.policy.step.zero_()
            self.data, (rewards, dones), mean = self.roll(self.data,
                                                          self.gen)
        t1 = clock()
        with self.span("bench.read"):
            float(mean)
        t2 = clock()
        self.outputs.append(rewards)
        if keep:
            out = {"qpos": self.data.qpos.T.clone(),
                   "qvel": self.data.qvel.T.clone(),
                   "time": self.data.time.clone(), "rewards": rewards,
                   "dones": dones.to(rewards.dtype),
                   "obs": self.record.transpose(1, 2).clone()}
            self.samples[index] = (inp, gen_state, out)
        return t0, t1, t2

    def drop(self, index: int):
        self.samples.pop(index, None)

    def release(self):
        """Count the failed env-calls (a non-finite reward), then free the
        program's state."""
        failed = sum(int((~torch.isfinite(r)).any(0).sum())
                     for r in self.outputs)
        self.outputs = []
        del self.roll, self.data, self.policy, self.benv
        return failed

    # ----- the comparison with the reference ------------------------------

    def reference(self, device):
        return GeneralCallReference(
            Task(self.spec.config, device), self.B, self.K, self.layers,
            self.sigma, float(self.spec.config["time_limit_s"]))

    def judge(self, ref, limits: dict, control: bool = False):
        """``start_gap`` (the reset against the reference's), and, the
        reference following the program step by step from the state the
        program handed the policy, ``step_over_share`` (the share of the
        sampled calls' (step, env) pairs whose largest relative gap of a
        step's outputs exceeds that number's ``over``) and
        ``end_over_share`` (the share of envs whose gap at the call's end,
        state and time, does); ``control`` puts the reference in bfloat16
        in the program's place."""
        gen = torch.Generator(device=self.device)
        gen.set_state(self.start_gen)
        qpos, qvel = ref.task.episode(gen, self.B, self.device)
        # the reset's answers (the warmstart is the program's solver hint,
        # which the reference has no use for)
        want0 = (qpos, qvel, torch.zeros_like(qpos[:, 0]))
        got0 = tuple(self.start[f] for f in ("qpos", "qvel", "time"))
        if control:
            got0 = tuple(x.to(torch.bfloat16).to(x.dtype) for x in want0)
        gaps, ends = [], []
        for index in sorted(self.samples):
            inp, gen_state, prog = self.samples[index]
            obs0 = prog["obs"][0].T
            if control:
                prog = ref.call(inp, obs0, gen_state, lowp=True)
            want = ref.call(inp, obs0, gen_state,
                            forced=(prog["obs"], prog["dones"]))
            gaps.append(compare.step_gaps(prog, want).flatten())
            ends.append(compare.end_gaps(prog, want))
        gaps, ends = torch.cat(gaps), torch.cat(ends)
        out = {"start_gap": compare.rel_gap_max(got0, want0),
               "step_over_share": compare.share_over(
                   gaps, limits["step_over_share"]["over"]),
               "end_over_share": compare.share_over(
                   ends, limits["end_over_share"]["over"])}
        return out, dict(compare.spread("step_gap", gaps),
                         **compare.spread("end_gap", ends))
