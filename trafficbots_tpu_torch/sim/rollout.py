"""Closed-loop rollout: `build_sim` and a Python loop over the steps.

Counterpart of `trafficbots_tpu/sim/rollout.py`, eval side. `build_sim`
returns the initial carry and the step body; `rollout` runs the body for
steps `step_start..step_end` and stacks the per-step outputs batch-major,
[B, A, n_step, ...], as the JAX package's scan does. Semantics kept from it:

  - the state override (teacher forcing) happens AFTER the dynamics update;
  - the policy sees traffic lights tl[min(step - 1, T_tl - 1)], the rule
    checker tl_stop[min(step, T - 1)];
  - kill() spares agents that are valid in the GT at the step;
  - `StepOutput.valid` is the validity BEFORE the override, while the carry
    continues with the overridden state;
  - steps past the GT horizon see GT padded with valid=False.

The deterministic path (deterministic latent and action, as in the eval
replay) draws no random numbers; a `torch.Generator` is needed only when a
sample is stochastic.

Training (`training=True`, the BPTT body of the JAX rollout): the map K/V
cache stays fp32; the goal/latent input MLPs run every step (their dropout
is per step); the policy's state inputs are detached under
`detach_state_policy`; the latent sample is detached for its log-prob;
`step_detach_hidden` and `p_drop_hidden` act on the hidden state. Every
step's dropout seeds come from a `DropoutSeeds` seeded by a number drawn
from the rollout's CPU generator OUTSIDE the step body, so that with
`remat_rollout_step` the recompute of a step under `torch.utils.checkpoint`
draws the same masks (checkpoint's `preserve_rng_state` restores only the
default generators, not a user generator read inside the body). Under
`remat_policy="save_attn"` each step's training attention cores keep their
outputs (`ops.dropout.SavedCores`), so the recompute replays them instead of
launching the forward kernel again; "none" recomputes everything.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ExperimentConfig
from ..data.preprocessing import agent_attr_and_pe
from ..distributions import DetType, DiagGaussian
from ..models.goal_manager import goal_feature as gather_goal_feature
from ..ops.dropout import SEED_BITS, DropoutSeeds, SavedCores
from .dynamics import AgentState, DynamicsParams, dynamics_update, init_agent_state, kill, override_states
from .rewards import RewardConfig, differentiable_reward
from .rules import RuleConfig, RuleConstants, RuleState, check_rules, init_rule_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RolloutCarry:
    agent: AgentState
    rules: RuleState
    hidden: Tensor  # [L, B, A, d]
    goal_valid: Optional[Tensor]  # [B, A]
    latent_sample: Optional[Tensor]  # [B, A, latent_dim]
    latent_logp: Optional[Tensor]  # [B, A]


@dataclasses.dataclass(frozen=True)
class StepOutput:
    valid: Tensor  # [B, A] pre-override validity
    pred: Tensor  # [B, A, 4]
    override_mask: Tensor  # [B, A]
    violations: Dict[str, Tensor]
    diffbar_reward: Tensor  # [B, A]
    diffbar_reward_valid: Tensor  # [B, A]
    latent_log_prob: Tensor  # [B, A]
    action_log_prob: Tensor  # [B, A]


@dataclasses.dataclass(frozen=True)
class RolloutOutput:
    valid: Tensor  # [B, A, S]
    preds: Tensor  # [B, A, S, 4]
    override_masks: Tensor  # [B, A, S]
    violations: Dict[str, Tensor]  # each [B, A, S]
    diffbar_rewards: Tensor  # [B, A, S]
    diffbar_rewards_valid: Tensor  # [B, A, S]
    latent_log_probs: Tensor  # [B, A, S]
    action_log_probs: Tensor  # [B, A, S]
    step_future_start: int = 10

    def flatten_repeat(self, n_repeat: int) -> "RolloutOutput":
        """[B * K, A, S, ...] -> [B, A, K, S, ...] (the K joint futures
        folded into the batch, batch-major, unfolded)."""

        def fr(x: Tensor) -> Tensor:
            B, A, S = x.shape[:3]
            return x.reshape(B // n_repeat, n_repeat, A, S, *x.shape[3:]).transpose(1, 2)

        return RolloutOutput(
            valid=fr(self.valid), preds=fr(self.preds), override_masks=fr(self.override_masks),
            violations={k: fr(v) for k, v in self.violations.items()},
            diffbar_rewards=fr(self.diffbar_rewards), diffbar_rewards_valid=fr(self.diffbar_rewards_valid),
            latent_log_probs=fr(self.latent_log_probs), action_log_probs=fr(self.action_log_probs),
            step_future_start=self.step_future_start,
        )


def pad_gt_features(features: Dict[str, Tensor], step_end: int) -> Dict[str, Tensor]:
    """Pad the GT arrays along the step axis to step_end + 1 with invalid zeros."""
    out = dict(features)
    need = step_end + 1 - features["agent_valid"].shape[1]
    if need > 0:
        for k in ("agent_valid", "agent_state", "vel", "acc", "yaw_rate"):
            x = features[k]
            pad = [0, 0] * (x.ndim - 2) + [0, need]
            out[k] = F.pad(x, pad)
    return out


def rule_config(cfg: ExperimentConfig) -> RuleConfig:
    rc = cfg.rule_checker
    return RuleConfig(
        enable_check_collided=rc.enable_check_collided,
        enable_check_run_road_edge=rc.enable_check_run_road_edge,
        enable_check_run_red_light=rc.enable_check_run_red_light,
        enable_check_passive=rc.enable_check_passive,
        collision_size_scale=rc.collision_size_scale,
    )


def build_sim(
    cfg: ExperimentConfig,
    model,
    dyn_params: DynamicsParams,
    rule_consts: RuleConstants,
    features: Dict[str, Tensor],
    latent_dist,
    goal: Optional[Tensor],
    goal_valid: Optional[Tensor],
    mask_teacher_forcing: Tensor,  # [B, T_gt, A]
    generator: Optional[torch.Generator] = None,
    deterministic_latent: DetType = True,
    deterministic_action: bool = True,
    step_end: int = 90,
    training: bool = False,
):
    """-> (carry0, body), body(carry, step, rng) -> (carry, StepOutput);
    `rng` (a DropoutSeeds) is given in training and None in eval.

    features (batch-major): map_valid [B,P], map_feature [B,P,d], tl_valid
    [B,T_tl,n_tl], tl_feature [B,T_tl,n_tl,d], agent_type [B,A,3],
    agent_size [B,A,3], agent_valid [B,T_gt,A], agent_state [B,T_gt,A,4],
    vel / acc / yaw_rate, tl_stop_valid / tl_stop_pos / tl_stop_state.
    """
    mcfg = cfg.model
    gcfg = mcfg.goal_manager
    rcfg = rule_config(cfg)
    rew = cfg.reward
    rew_cfg = RewardConfig(
        w_collision=rew.w_collision, reduce_collision_with_max=rew.reduce_collision_with_max,
        use_il_loss=rew.use_il_loss, w_pos=rew.w_pos, criterion_pos=rew.criterion_pos,
        w_rot=rew.w_rot, criterion_rot=rew.criterion_rot, angular_type_rot=rew.angular_type_rot,
        w_spd=rew.w_spd, criterion_spd=rew.criterion_spd,
    )
    features = pad_gt_features(features, step_end)
    B, _, A = features["agent_valid"].shape
    dev = features["agent_valid"].device
    need = step_end + 1 - mask_teacher_forcing.shape[1]
    if need > 0:
        mask_teacher_forcing = F.pad(mask_teacher_forcing, [0, 0, 0, need])

    agent0 = init_agent_state(
        valid=features["agent_valid"][:, 0], state=features["agent_state"][:, 0],
        vel=features["vel"][:, 0], acc=features["acc"][:, 0], yaw_rate=features["yaw_rate"][:, 0],
    )
    latent_sample = latent_logp = None
    if latent_dist is not None:
        latent_sample = latent_dist.sample(generator, deterministic_latent)
        latent_logp = latent_dist.log_prob(latent_sample.detach())

    goal_is_none = goal is None or gcfg.goal_attr_mode == "dummy"
    update_goal = gcfg.goal_attr_mode == "goal_xy" and gcfg.goal_in_local

    def get_goal_feature(agent_state: Tensor) -> Optional[Tensor]:
        if goal_is_none:
            return None
        return gather_goal_feature(gcfg, goal, agent_state, features["map_feature"])

    goal_feature_static = None if update_goal else get_goal_feature(agent0.state)
    map_kv = model.precompute_map_kv(features["map_feature"], training=training)

    goal_z_pre = latent_z_pre = None
    if not training and not update_goal and not mcfg.resample_latent:
        ever_valid = features["agent_valid"].any(dim=1) | agent0.valid
        goal_z_pre, latent_z_pre = model.precompute_add_feats(
            goal_feature_static, goal_valid, latent_sample, ever_valid
        )

    carry0 = RolloutCarry(
        agent=agent0, rules=init_rule_state(B, A, dev),
        hidden=model.init_hidden(B, A, dev), goal_valid=goal_valid,
        latent_sample=latent_sample, latent_logp=latent_logp,
    )

    T_tl = features["tl_valid"].shape[1]
    if rcfg.enable_check_run_red_light or rcfg.enable_check_passive:
        tl_stop = (features["tl_stop_valid"], features["tl_stop_pos"], features["tl_stop_state"])
    else:
        n_tl = features["tl_valid"].shape[2]
        tl_stop = (
            torch.zeros((B, 1, n_tl), dtype=torch.bool, device=dev),
            torch.zeros((B, 1, n_tl, 2), device=dev),
            torch.zeros((B, 1, n_tl, 5), dtype=torch.bool, device=dev),
        )
    T_tls = tl_stop[0].shape[1]

    def body(carry: RolloutCarry, step: int, rng: Optional[DropoutSeeds]) -> Tuple[RolloutCarry, StepOutput]:
        agent = carry.agent
        mask_override = mask_teacher_forcing[:, step]
        gt_valid = features["agent_valid"][:, step]
        gt_state = features["agent_state"][:, step]
        state_override = {
            "state": gt_state, "vel": features["vel"][:, step],
            "acc": features["acc"][:, step], "yaw_rate": features["yaw_rate"][:, step],
        }
        tl_idx = min(max(step - 1, 0), T_tl - 1)

        latent_sample, latent_logp = carry.latent_sample, carry.latent_logp
        if mcfg.resample_latent and latent_dist is not None:
            gen = generator if rng is None else rng.generator(dev)
            latent_sample = latent_dist.sample(gen, deterministic_latent)
            latent_logp = latent_dist.log_prob(latent_sample.detach())
        goal_feature = get_goal_feature(agent.state) if update_goal else goal_feature_static

        attr, pe = agent_attr_and_pe(
            mcfg, agent_pos=agent.state[..., :2], agent_yaw_bbox=agent.state[..., 2:3],
            agent_vel=agent.vel, agent_spd=agent.state[..., 3:4], agent_yaw_rate=agent.yaw_rate,
            agent_acc=agent.acc, agent_size=features["agent_size"], agent_type=features["agent_type"],
        )
        if rng is not None and cfg.detach_state_policy:
            attr, pe = attr.detach(), pe.detach()
        agent_feature = model.encode_agent(agent.valid, attr, pe, rng=rng)
        action_mean, action_log_std, hidden, _ = model.policy_step(
            agent_valid=agent.valid, agent_feature=agent_feature,
            map_valid=features["map_valid"], map_feature=features["map_feature"], map_kv=map_kv,
            tl_valid=features["tl_valid"][:, tl_idx], tl_feature=features["tl_feature"][:, tl_idx],
            goal_valid=carry.goal_valid, goal_feature=goal_feature, latent_sample=latent_sample,
            hidden=carry.hidden, agent_type=features["agent_type"],
            goal_z_pre=goal_z_pre, latent_z_pre=latent_z_pre, rng=rng,
        )
        action_gen = generator
        if rng is not None and deterministic_action is not True:
            action_gen = rng.generator(dev)
        new_agent, _, action_logp = dynamics_update(
            dyn_params, agent, features["agent_type"],
            DiagGaussian(mean=action_mean, log_std=action_log_std),
            action_gen, deterministic=deterministic_action,
        )
        pred_valid, pred_state = new_agent.valid, new_agent.state
        new_agent = override_states(new_agent, state_override, mask_override)

        tls_idx = min(max(step, 0), T_tls - 1)
        new_rules, violations = check_rules(
            rcfg, rule_consts, carry.rules, new_agent.valid, new_agent.state,
            tl_stop[0][:, tls_idx], tl_stop[1][:, tls_idx], tl_stop[2][:, tls_idx],
        )
        new_agent = kill(new_agent, violations["outside_map_this_step"], gt_valid)

        new_goal_valid = carry.goal_valid
        if new_goal_valid is not None:
            new_goal_valid = new_goal_valid & new_agent.valid
            if gcfg.disable_if_reached:
                if gcfg.goal_attr_mode == "dest":
                    new_goal_valid = new_goal_valid & ~violations["dest_reached"]
                elif gcfg.goal_attr_mode == "goal_xy":
                    new_goal_valid = new_goal_valid & ~violations["goal_reached"]

        reward, reward_valid = differentiable_reward(
            rew_cfg, pred_valid, pred_state, gt_valid, gt_state, features["agent_size"]
        )
        if rng is not None and 0 <= step <= cfg.step_detach_hidden:
            hidden = hidden.detach()
        if rng is not None and cfg.p_drop_hidden > 0 and rng.next() < cfg.p_drop_hidden * 2**SEED_BITS:
            hidden = torch.zeros_like(hidden)
        out = StepOutput(
            valid=pred_valid, pred=pred_state, override_mask=mask_override, violations=violations,
            diffbar_reward=reward, diffbar_reward_valid=reward_valid,
            latent_log_prob=latent_logp if latent_logp is not None else torch.zeros_like(action_logp),
            action_log_prob=action_logp,
        )
        new_carry = RolloutCarry(
            agent=new_agent, rules=new_rules, hidden=hidden, goal_valid=new_goal_valid,
            latent_sample=latent_sample, latent_logp=latent_logp,
        )
        return new_carry, out

    return carry0, body


def rollout(
    cfg: ExperimentConfig,
    model,
    dyn_params: DynamicsParams,
    rule_consts: RuleConstants,
    features: Dict[str, Tensor],
    latent_dist,
    goal: Optional[Tensor],
    goal_valid: Optional[Tensor],
    mask_teacher_forcing: Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic_latent: DetType = True,
    deterministic_action: bool = True,
    step_start: int = 1,
    step_end: int = 90,
    training: bool = False,
) -> RolloutOutput:
    """Run the closed loop for steps step_start..step_end. Training needs
    `generator`, a CPU generator: the latent sample and every step's seed
    come from it."""
    if training and cfg.remat_rollout_step and cfg.remat_policy not in ("none", "save_attn"):
        raise NotImplementedError(f"remat_policy={cfg.remat_policy!r}: the port has 'none' and 'save_attn'")
    carry, body = build_sim(
        cfg, model, dyn_params, rule_consts, features, latent_dist, goal, goal_valid,
        mask_teacher_forcing, generator, deterministic_latent=deterministic_latent,
        deterministic_action=deterministic_action, step_end=step_end, training=training,
    )

    def checkpointed(carry, step, seed, saved):
        return body(carry, step, DropoutSeeds(seed, saved))

    outs = []
    for step in range(step_start, step_end + 1):
        if not training:
            carry, out = body(carry, step, None)
        else:
            seed = int(torch.randint(0, 2**SEED_BITS, (1,), generator=generator).item())
            if cfg.remat_rollout_step:
                saved = SavedCores() if cfg.remat_policy == "save_attn" else None
                # the body reads no default generator: nothing to preserve
                carry, out = checkpoint(checkpointed, carry, step, seed, saved,
                                        use_reentrant=False, preserve_rng_state=False)
            else:
                carry, out = body(carry, step, DropoutSeeds(seed))
        outs.append(out)

    def stack(get):
        return torch.stack([get(o) for o in outs], dim=2)

    return RolloutOutput(
        valid=stack(lambda o: o.valid),
        preds=stack(lambda o: o.pred),
        override_masks=stack(lambda o: o.override_mask),
        violations={k: stack(lambda o, k=k: o.violations[k]) for k in outs[0].violations},
        diffbar_rewards=stack(lambda o: o.diffbar_reward),
        diffbar_rewards_valid=stack(lambda o: o.diffbar_reward_valid),
        latent_log_probs=stack(lambda o: o.latent_log_prob),
        action_log_probs=stack(lambda o: o.action_log_prob),
        step_future_start=cfg.time_step_current + 1 - step_start,
    )
