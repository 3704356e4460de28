"""Interactive (step-at-a-time) closed-loop simulation.

Counterpart of `trafficbots_tpu/sim/interactive.py`. `rollout` runs
`build_sim`'s step body over the whole horizon in one call; `InteractiveSim`
runs the SAME body one step per `step()`, so a caller can read the state,
edit it, or force agents between steps (sim-as-a-service: drive some
agents externally against the learned policy; what-if probing; debugging).
Both run the same operations in the same order, so `run_to_end().finish()`
equals `rollout` (and `orchestration.reactive_replay`) bitwise, booleans and
floats alike, and N steps give the rollout's first N step columns.

A step's override is the teacher-forcing input of the rollout: agents with
`mask_override` True are forced to `state_override` after the dynamics
update (see `sim.rollout.build_sim`). Eval only: the steps run without
dropout and without autograd.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..orchestration import resolve_device
from .rollout import RolloutCarry, RolloutOutput, StepOutput, build_sim, stack_outputs

Tensor = torch.Tensor


class InteractiveSim:
    """The step body with its carry, stepped from the host.

    `carry` (a RolloutCarry) may be replaced between steps for state
    surgery, e.g. `sim.carry = dataclasses.replace(sim.carry, agent=...)`;
    `t` counts the steps taken."""

    def __init__(self, carry: RolloutCarry, body, steps: List[int], step_future_start: int):
        self.carry = carry
        self.t = 0
        self.outputs: List[StepOutput] = []
        self._body = body
        self._steps = steps
        self._step_future_start = step_future_start

    @property
    def n_steps(self) -> int:
        return len(self._steps)

    @property
    def done(self) -> bool:
        return self.t >= self.n_steps

    @torch.no_grad()
    def step(
        self,
        mask_override: Optional[Tensor] = None,  # [B, A] bool
        state_override: Optional[Dict[str, Tensor]] = None,
    ) -> StepOutput:
        """Advance one step. Overrides REPLACE this step's teacher forcing:
        agents with `mask_override` True are forced to `state_override`
        (keys state [B,A,4], vel [B,A,2], acc [B,A,1], yaw_rate [B,A,1])
        after the dynamics update. A channel left out of `state_override`
        forces the masked agents to this step's GT of that channel, which
        is stale or zero outside their GT-valid window: give every channel
        for such agents. `state_override` without `mask_override` raises
        ValueError."""
        if self.done:
            raise RuntimeError(f"the simulation finished after {self.n_steps} steps")
        self.carry, out = self._body(self.carry, self._steps[self.t], None, mask_override, state_override)
        self.outputs.append(out)
        self.t += 1
        return out

    def run_to_end(self) -> "InteractiveSim":
        while not self.done:
            self.step()
        return self

    def finish(self) -> RolloutOutput:
        """The steps taken so far as the rollout's batch-major RolloutOutput."""
        if not self.outputs:
            raise RuntimeError("no steps taken")
        return stack_outputs(self.outputs, self._step_future_start)


def make_interactive_sim(
    cfg,
    model,
    dyn_params,
    rule_consts,
    features: Dict[str, Tensor],
    latent_dist,
    goal: Optional[Tensor],
    goal_valid: Optional[Tensor],
    mask_teacher_forcing: Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic_latent=True,
    deterministic_action: bool = True,
    step_start: int = 1,
    step_end: int = 90,
    device="cuda",
) -> InteractiveSim:
    """An InteractiveSim over `rollout`'s arguments (eval), on `device`: the
    card unless the caller asks for the CPU; without CUDA it raises. The
    features must lie on that device."""
    device = resolve_device(device)
    if features["agent_valid"].device.type != device.type:
        raise ValueError(f"the features lie on {features['agent_valid'].device}, not on {device}")
    with torch.no_grad():
        carry0, body = build_sim(
            cfg, model, dyn_params, rule_consts, features, latent_dist, goal, goal_valid, mask_teacher_forcing,
            generator, deterministic_latent=deterministic_latent, deterministic_action=deterministic_action,
            step_end=step_end,
        )
    return InteractiveSim(carry0, body, list(range(step_start, step_end + 1)),
                          step_future_start=cfg.time_step_current + 1 - step_start)
