"""Kinematic action integrators as functions over an `AgentState`.

Counterpart of `trafficbots_tpu/sim/dynamics.py`. The per-type parameters
are [3, ...] tables selected by the agent-type one-hot, so one fp32
expression covers all agents (the one-hot picks exactly one term, which is
exact in IEEE arithmetic). Physics stays fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributions import DetType, DiagGaussian
from ..geometry import cast_rad

Tensor = torch.Tensor

KIND_MULTIPATHPP = 0  # midpoint-Euler unicycle
KIND_STATE_INTEGRATOR = 1  # vx/vy integrator (TrafficSim)


@dataclasses.dataclass(frozen=True)
class DynamicsParams:
    action_scale: Tensor  # [3, 2]
    kind: Tensor  # [3] int32
    disable_neg_spd: Tensor  # [3] bool
    dt: float = 0.1
    any_state_integrator: bool = False
    any_multipathpp: bool = True


def make_dynamics_params(
    veh: Dict, ped: Dict, cyc: Dict, dt: float = 0.1, use_veh_dynamics_for_all: bool = False,
    device=None,
) -> DynamicsParams:
    cfgs = [veh, veh, veh] if use_veh_dynamics_for_all else [veh, ped, cyc]
    scale = np.zeros((3, 2), dtype=np.float32)
    kind = np.zeros((3,), dtype=np.int32)
    dns = np.zeros((3,), dtype=bool)
    for i, c in enumerate(cfgs):
        k = c.get("kind", "multipathpp")
        if k == "multipathpp":
            kind[i] = KIND_MULTIPATHPP
            scale[i] = (c.get("max_acc", 4.0), c.get("max_yaw_rate", 1.0))
            dns[i] = c.get("disable_neg_spd", False)
        elif k == "state_integrator":
            kind[i] = KIND_STATE_INTEGRATOR
            scale[i] = (c.get("max_v", 3.0), c.get("max_v", 3.0))
        else:
            raise ValueError(f"unknown dynamics kind {k}")
    return DynamicsParams(
        action_scale=torch.as_tensor(scale, device=device),
        kind=torch.as_tensor(kind, device=device),
        disable_neg_spd=torch.as_tensor(dns, device=device),
        dt=dt,
        any_state_integrator=bool((kind == KIND_STATE_INTEGRATOR).any()),
        any_multipathpp=bool((kind == KIND_MULTIPATHPP).any()),
    )


@dataclasses.dataclass(frozen=True)
class AgentState:
    valid: Tensor  # [B, A] bool
    killed: Tensor  # [B, A] bool
    state: Tensor  # [B, A, 4] x, y, yaw, spd
    vel: Tensor  # [B, A, 2]
    acc: Tensor  # [B, A, 1]
    yaw_rate: Tensor  # [B, A, 1]

    def replace(self, **kw) -> "AgentState":
        return dataclasses.replace(self, **kw)


def init_agent_state(valid: Tensor, state: Tensor, vel: Tensor, acc: Tensor, yaw_rate: Tensor) -> AgentState:
    return AgentState(
        valid=valid, killed=torch.zeros_like(valid), state=state.float(), vel=vel.float(),
        acc=acc.float(), yaw_rate=yaw_rate.float(),
    )


def _update_multipathpp(state, acc, yaw_rate, dt: float, disable_neg_spd):
    """Midpoint-Euler unicycle (op order of the JAX package)."""
    v_tilde = state[:, :, 3] + 0.5 * dt * acc
    theta_tilde = state[:, :, 2] + 0.5 * dt * yaw_rate
    delta = torch.stack(
        [v_tilde * torch.cos(theta_tilde), v_tilde * torch.sin(theta_tilde), yaw_rate, acc], dim=-1
    )
    new_state = state + dt * delta
    # the reference overwrites the NEW speed with relu of the OLD speed
    new_spd = torch.where(disable_neg_spd, torch.relu(state[..., 3]), new_state[..., 3])
    new_state = torch.cat([new_state[..., :3], new_spd[..., None]], dim=-1)
    vel = (new_state[:, :, :2] - state[:, :, :2]) / dt
    return new_state, vel


def _update_state_integrator(state, action, dt: float):
    """The vx/vy integrator: gradients flow through the position and the
    velocity only; heading, speed, acceleration and yaw rate are derived
    and detached, as in the JAX package."""
    vx, vy = action[:, :, 0], action[:, :, 1]
    theta = torch.atan2(vy, vx).detach()
    spd = torch.linalg.norm(action, dim=-1).detach()
    new_xy = state[..., :2] + action * dt
    new_state = torch.cat([new_xy, theta[..., None], spd[..., None]], dim=-1)
    acc = ((spd - state[:, :, 3]) / dt).detach()
    yaw_rate = (cast_rad(theta - state[:, :, 2]) / dt).detach()
    return new_state, action, acc, yaw_rate


def dynamics_update(
    params: DynamicsParams,
    agent: AgentState,
    agent_type: Tensor,  # [B, A, 3] bool one-hot
    action_dist: DiagGaussian,
    generator: Optional[torch.Generator] = None,
    deterministic: DetType = True,
) -> Tuple[AgentState, Tensor, Tensor]:
    """One integration step -> (new AgentState, action [B,A,2], action log-prob [B,A])."""
    type_f = agent_type.float()
    invalid = ~agent.valid
    action_unbounded = action_dist.sample(generator, deterministic)
    action_log_prob = action_dist.log_prob(action_unbounded.detach())
    action_log_prob = torch.where(invalid, torch.zeros_like(action_log_prob), action_log_prob)

    scale = torch.einsum("nat,td->nad", type_f, params.action_scale)
    action = torch.tanh(action_unbounded) * scale
    action = torch.where(invalid[..., None], torch.zeros_like(action), action)

    state = agent.state
    acc_in = action[:, :, 0]
    yawr_in = action[:, :, 1]
    dns = torch.einsum("nat,t->na", type_f, params.disable_neg_spd.float()) > 0.5
    if params.any_multipathpp and params.any_state_integrator:
        s_mpp, v_mpp = _update_multipathpp(state, acc_in, yawr_in, params.dt, dns)
        s_si, v_si, a_si, yr_si = _update_state_integrator(state, action, params.dt)
        kind = torch.einsum("nat,t->na", type_f, params.kind.float()) > 0.5
        new_state = torch.where(kind[..., None], s_si, s_mpp)
        vel = torch.where(kind[..., None], v_si, v_mpp)
        acc = torch.where(kind, a_si, acc_in)[..., None]
        yaw_rate = torch.where(kind, yr_si, yawr_in)[..., None]
    elif params.any_state_integrator:
        new_state, vel, acc, yaw_rate = _update_state_integrator(state, action, params.dt)
        acc, yaw_rate = acc[..., None], yaw_rate[..., None]
    else:
        new_state, vel = _update_multipathpp(state, acc_in, yawr_in, params.dt, dns)
        acc, yaw_rate = acc_in[..., None], yawr_in[..., None]

    inv3 = invalid[..., None]

    def zero_invalid(t):
        return torch.where(inv3, torch.zeros_like(t), t)

    new_agent = agent.replace(
        state=zero_invalid(new_state), vel=zero_invalid(vel),
        acc=zero_invalid(acc), yaw_rate=zero_invalid(yaw_rate),
    )
    return new_agent, action, action_log_prob


def override_states(agent: AgentState, state_override: Dict[str, Tensor], mask_state_override: Tensor) -> AgentState:
    """Teacher forcing / agent spawning: masked agents take the GT state."""
    mask = mask_state_override & ~agent.killed
    m3 = mask[..., None]
    return agent.replace(
        valid=agent.valid | mask,
        state=torch.where(m3, state_override["state"], agent.state),
        vel=torch.where(m3, state_override["vel"], agent.vel),
        acc=torch.where(m3, state_override["acc"], agent.acc),
        yaw_rate=torch.where(m3, state_override["yaw_rate"], agent.yaw_rate),
    )


def kill(agent: AgentState, outside_map_this_step: Tensor, gt_valid: Optional[Tensor] = None) -> AgentState:
    """Kill agents that left the map, sparing those valid in the GT."""
    mask_kill = outside_map_this_step
    if gt_valid is not None:
        mask_kill = mask_kill & ~gt_valid
    return agent.replace(killed=agent.killed | mask_kill, valid=agent.valid & ~mask_kill)
