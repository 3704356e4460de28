"""Episode-level orchestration: model construction, episode encoding, reactive replay.

Counterpart of `trafficbots_tpu/orchestration.py` up to `reactive_replay`,
`joint_future_pred` and `training_step`, plus `eval_rollout`, the eval main
path: the counterpart of the program `bench.py` times,

    pre_processing -> encode_episode_features -> posterior latent
    -> get_gt_goal -> teacher_forcing_mask -> reactive_replay (91 steps)

in eval mode with a deterministic latent and action. `training_step` is the
training forward pass (training views, one shared map encode, goal head,
posterior and prior latents, the prior coin, teacher forcing, the 90-step
training rollout, `training.loss.training_loss`); `training.train` wraps it
with the backward and the optimizer. `joint_future_pred` is validation's
K-future rollout (`evaluation_loop`).

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, as the tests do); without CUDA they raise instead of
carrying on quietly on the CPU. fp32 matmuls stay IEEE fp32 (TF32 off).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .config import ExperimentConfig
from .data.preprocessing import Batch, extract, map_attr, pre_processing, to_torch
from .geometry import pose_pe
from .models import goal_manager as GM
from .models.traffic_bots import TrafficBots
from .ops.dropout import SEED_BITS, DropoutSeeds
from .sim import rules as RU
from .sim.dynamics import make_dynamics_params
from .sim.rollout import RolloutOutput, rollout, rule_config
from .sim.teacher_forcing import TeacherForcingConfig, teacher_forcing_mask
from .training.loss import training_loss

Tensor = torch.Tensor

VIEWS = ("input", "latent_post", "latent_prior")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on, with fp32 matmuls kept IEEE.
    Raises when CUDA is asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def make_model(cfg: ExperimentConfig, device="cuda", seed: Optional[int] = None) -> TrafficBots:
    """The policy in eval mode on `device`; weights from the port's seeded
    init when `seed` is given (else load them with weights.load_jax_params)."""
    from .weights import init_params

    if cfg.precision != "fp32":
        raise NotImplementedError("the port runs the model in fp32")
    device = resolve_device(device)
    model = TrafficBots(cfg.model, cfg.action_head, cfg.data)
    if seed is not None:
        init_params(model, seed)
    return model.to(device).eval()


def make_dyn_params(cfg: ExperimentConfig, device=None):
    return make_dynamics_params(
        veh=cfg.dynamics.veh.as_dict(), ped=cfg.dynamics.ped.as_dict(), cyc=cfg.dynamics.cyc.as_dict(),
        dt=cfg.dynamics.dt, use_veh_dynamics_for_all=cfg.dynamics.use_veh_dynamics_for_all,
        device=device,
    )


def tf_cfg_to_sim(tf) -> TeacherForcingConfig:
    return TeacherForcingConfig(
        step_spawn_agent=tf.step_spawn_agent, step_warm_start=tf.step_warm_start,
        step_horizon=tf.step_horizon, step_horizon_decrease_per_epoch=tf.step_horizon_decrease_per_epoch,
        prob_forcing_agent=tf.prob_forcing_agent,
        prob_forcing_agent_decrease_per_epoch=tf.prob_forcing_agent_decrease_per_epoch,
        gt_sdc=getattr(tf, "gt_sdc", False),
    )


def encode_map_chunked(
    model: TrafficBots, batch: Batch, chunk: int, rng: Optional[DropoutSeeds] = None,
) -> Tuple[Tensor, Tensor]:
    """The episode map encode over scene chunks of `chunk`, each with its own
    PE and attributes, so the [chunk, P, N, *] featurization temporaries are
    the largest that exist. Per-scene results do not depend on the chunk
    (in eval; a training encode is one chunk, its dropout drawn from `rng`)."""
    mcfg = model.cfg
    feats, valids = [], []
    n_scene, _, n_node = batch["sc/map_valid"].shape
    for s in range(0, n_scene, chunk):
        sl = slice(s, s + chunk)
        pos = batch["sc/map_pos"][sl]
        pe = pose_pe(pos, batch["sc/map_dir"][sl], mcfg.pose_pe_map, mcfg.pe_dim)
        attr = map_attr(batch["sc/map_type"][sl], n_node, pos.dtype)
        f, v = model.map_only(batch["input/map_valid"][sl], attr, pe, rng=rng)
        feats.append(f)
        valids.append(v)
    return torch.cat(feats), torch.cat(valids)


def encode_episode_features(
    model: TrafficBots, batch: Batch, views: Iterable[str] = VIEWS, rng: Optional[DropoutSeeds] = None,
) -> Dict[str, Dict[str, Tensor]]:
    """Encode the episode views; the map is encoded once and shared by every
    view, as the JAX package does whenever the views see one map (training
    included: docs/divergences.md). In eval the map encode runs in chunks of
    `map_encode_chunk` scenes when that is > 0; a training encode (`rng`
    given) is one chunk, as in the JAX package."""
    chunk = model.cfg.map_encode_chunk
    n_scene = batch["sc/map_valid"].shape[0]
    if rng is not None or chunk <= 0:
        chunk = n_scene
    shared_map = encode_map_chunked(model, batch, chunk, rng)
    out = {}
    for prefix in views:
        if f"{prefix}/agent_valid" not in batch:
            continue
        view = extract(batch, prefix)
        view["map_feature"], view["map_feature_valid"] = shared_map
        out[prefix] = model.encode_input_features(**view, rng=rng)
    return out


def build_rollout_features(batch: Batch, input_features: Dict[str, Tensor]) -> Batch:
    """The rollout's features dict (see sim.rollout.build_sim)."""
    return {
        "map_valid": input_features["map_feature_valid"],
        "map_feature": input_features["map_feature"],
        "tl_valid": input_features["tl_feature_valid"],
        "tl_feature": input_features["tl_feature"],
        "agent_type": batch["sc/agent_type"],
        "agent_size": batch["sc/agent_size"],
        "agent_valid": batch["agent/valid"],
        "vel": batch["agent/vel"],
        "acc": batch["agent/acc"],
        "yaw_rate": batch["agent/yaw_rate"],
        "agent_state": torch.cat([batch["agent/pos"], batch["agent/yaw_bbox"], batch["agent/spd"]], dim=-1),
        "tl_stop_valid": batch["tl_stop/valid"],
        "tl_stop_pos": batch["tl_stop/pos"],
        "tl_stop_state": batch["tl_stop/state"],
    }


def make_rule_constants(cfg: ExperimentConfig, batch: Batch, goal, dest) -> RU.RuleConstants:
    return RU.init_rule_constants(
        map_boundary=batch["map/boundary"], map_valid=batch["map/valid"], map_type=batch["map/type"],
        map_pos=batch["map/pos"], map_dir=batch["map/dir"],
        agent_type=batch["agent/type"] if "agent/type" in batch else batch["history/agent/type"],
        agent_size=batch["agent/size"] if "agent/size" in batch else batch["history/agent/size"],
        agent_goal=goal, agent_dest=dest, cfg=rule_config(cfg),
    )


def reactive_replay(
    cfg: ExperimentConfig,
    model: TrafficBots,
    batch: Batch,
    features: Dict[str, Tensor],
    latent_dist,
    goal,
    goal_valid,
    mask_teacher_forcing: Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic_latent=True,
    deterministic_action: bool = True,
    training: bool = False,
) -> RolloutOutput:
    """Scene-reconstruction rollout over steps time_step_sim_start..time_step_end."""
    device = batch["agent/valid"].device
    return rollout(
        cfg=cfg, model=model, dyn_params=make_dyn_params(cfg, device),
        rule_consts=make_rule_constants(cfg, batch, batch.get("agent/goal"), batch.get("agent/dest")),
        features=build_rollout_features(batch, features), latent_dist=latent_dist,
        goal=goal, goal_valid=goal_valid, mask_teacher_forcing=mask_teacher_forcing,
        generator=generator, deterministic_latent=deterministic_latent,
        deterministic_action=deterministic_action,
        step_start=cfg.time_step_sim_start, step_end=cfg.time_step_end, training=training,
    )


def get_gt_goal(cfg: ExperimentConfig, agent_valid, gt_goal, gt_dest):
    return GM.get_gt_goal(cfg.model.goal_manager, agent_valid, gt_goal, gt_dest)


def _repeat_batch_keys(batch: Batch, keys: Iterable[str], k: int) -> Batch:
    out = dict(batch)
    for key in keys:
        if key in batch:
            out[key] = torch.repeat_interleave(batch[key], k, dim=0)
    return out


JOINT_FUTURE_KEYS = (
    "map/boundary", "map/valid", "map/type", "map/pos", "map/dir",
    "tl_stop/valid", "tl_stop/pos", "tl_stop/state",
    "sc/agent_type", "sc/agent_size",
    "agent/valid", "agent/vel", "agent/acc", "agent/yaw_rate",
    "agent/pos", "agent/yaw_bbox", "agent/spd",
    "history/agent/type", "history/agent/size",
    "history/tl_stop/valid", "history/tl_stop/pos", "history/tl_stop/state",
)


def joint_future_pred(
    cfg: ExperimentConfig,
    model: TrafficBots,
    batch: Batch,
    input_features: Dict[str, Tensor],
    latent_dist,
    goal_dist,
    goal_valid: Optional[Tensor],
    generator: Optional[torch.Generator] = None,
) -> Tuple[RolloutOutput, Optional[Tensor], Tensor]:
    """K = n_joint_future futures folded into the batch axis (scene-major:
    row b * K + k): future 0 deterministic, futures 1.. sampled from the
    prior latent and the goal distribution, every action deterministic.
    `generator` draws the goal samples, then the latent samples.

    Returns (the rollout unfolded to [B, A, K, S, ...], goal_sample [B, A,
    K(, 2)] or None, goal_log_probs [B, A, K])."""
    k_futures = cfg.n_joint_future
    mode = cfg.model.goal_manager.goal_attr_mode
    hist_valid = batch["history/agent/valid"] if "history/agent/valid" in batch else batch["agent/valid"][:, :1]
    n_batch, _, n_agent = hist_valid.shape
    dev = hist_valid.device
    det = torch.zeros((n_batch * k_futures, n_agent), dtype=torch.bool, device=dev)
    det[::k_futures] = True

    latent_k = latent_dist.repeat(k_futures, axis=0) if latent_dist is not None else None
    goal_sample = goal_valid_k = rc_goal = rc_dest = None
    goal_log_probs = torch.zeros((n_batch, n_agent, k_futures), device=dev)
    if goal_dist is not None:
        goal_k = goal_dist.repeat(k_futures, axis=0)
        goal_sample = goal_k.sample(generator, det)
        glp = goal_k.log_prob(goal_sample)
        goal_valid_k = torch.repeat_interleave(goal_valid, k_futures, dim=0)
        if mode == "dest":
            rc_dest = goal_sample
        elif mode == "goal_xy":
            rc_goal = goal_sample
        goal_log_probs = glp.reshape(n_batch, k_futures, n_agent).transpose(1, 2)

    if rc_dest is None and "agent/dest" in batch:
        rc_dest = torch.repeat_interleave(batch["agent/dest"], k_futures, dim=0)
    if rc_goal is None and "agent/goal" in batch:
        rc_goal = torch.repeat_interleave(batch["agent/goal"], k_futures, dim=0)
    if rc_goal is not None and rc_goal.shape[-1] == 2:
        # a sampled goal_xy has no yaw or speed; the goal-reached check reads 4 dims
        rc_goal = torch.cat([rc_goal, torch.zeros_like(rc_goal)], dim=-1)

    batch_k = _repeat_batch_keys(batch, JOINT_FUTURE_KEYS, k_futures)
    # the rule checker reads the history's traffic lights when there is one
    if "history/tl_stop/valid" in batch:
        for k in ("valid", "pos", "state"):
            batch_k[f"tl_stop/{k}"] = batch_k[f"history/tl_stop/{k}"]
    batch_k["agent/type"] = batch_k.get("history/agent/type", batch_k.get("sc/agent_type"))
    batch_k["agent/size"] = batch_k.get("history/agent/size", batch_k.get("sc/agent_size"))
    feats_k = {k: torch.repeat_interleave(v, k_futures, dim=0) for k, v in input_features.items()}
    mask_tf = teacher_forcing_mask(tf_cfg_to_sim(cfg.tf_joint_future_pred), batch_k["agent/valid"])
    buf = rollout(
        cfg=cfg, model=model, dyn_params=make_dyn_params(cfg, dev),
        rule_consts=make_rule_constants(cfg, batch_k, rc_goal, rc_dest),
        features=build_rollout_features(batch_k, feats_k), latent_dist=latent_k,
        goal=goal_sample, goal_valid=goal_valid_k, mask_teacher_forcing=mask_tf, generator=generator,
        deterministic_latent=det, deterministic_action=True,
        step_start=cfg.time_step_sim_start, step_end=cfg.time_step_end,
    ).flatten_repeat(k_futures)

    if goal_sample is not None:
        goal_sample = goal_sample.reshape(n_batch, k_futures, n_agent, *goal_sample.shape[2:]).transpose(1, 2)
    return buf, goal_sample, goal_log_probs


@torch.no_grad()
def eval_rollout(
    cfg: ExperimentConfig, model: TrafficBots, batch: Dict[str, np.ndarray], device="cuda",
) -> RolloutOutput:
    """The main path: a numpy episode batch (the data.synthetic contract) ->
    the 91-step eval reactive replay with the posterior latent, GT goals and
    a deterministic latent and action."""
    device = resolve_device(device)
    tbatch = to_torch(batch, device)
    pbatch = pre_processing(tbatch, cfg.model, training=False)
    feats = encode_episode_features(model, pbatch, views=("input", "latent_post"))
    goal_gt, goal_valid = get_gt_goal(cfg, pbatch["input/agent_valid"], pbatch["gt/goal"], pbatch["gt/dest"])
    latent_post = model.latent(posterior=True, **feats["latent_post"])
    mask_tf = teacher_forcing_mask(tf_cfg_to_sim(cfg.tf_reactive_replay), pbatch["gt/valid"])
    return reactive_replay(
        cfg, model, pbatch, feats["input"], latent_post, goal_gt, goal_valid, mask_tf,
        deterministic_latent=True, deterministic_action=True,
    )


def draw_seeds(generator: torch.Generator) -> DropoutSeeds:
    """A DropoutSeeds for one forward phase, seeded from `generator`."""
    return DropoutSeeds(int(torch.randint(0, 2**SEED_BITS, (1,), generator=generator).item()))


def training_step(
    cfg: ExperimentConfig, model: TrafficBots, batch: Batch, generator: torch.Generator, current_epoch: int = 0,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One training forward pass on a raw tensor batch (the data.synthetic
    contract, on the model's device) -> (loss, metrics). `generator` is a
    CPU generator: every random draw of the step comes from it, in a fixed
    order (dropout seeds of the encode, the goal head, the posterior and
    the prior; the prior coin; the teacher-forcing draws; the latent sample
    and the rollout's per-step seeds; the irrelevant-agent draws)."""
    pbatch = pre_processing(batch, cfg.model, n_step_hist=cfg.time_step_current + 1, training=True)
    feats = encode_episode_features(model, pbatch, rng=draw_seeds(generator))
    goal_gt = goal_valid = goal_pred = None
    if cfg.model.goal_manager.goal_attr_mode != "dummy":
        goal_gt, goal_valid = get_gt_goal(cfg, pbatch["input/agent_valid"], pbatch["gt/goal"], pbatch["gt/dest"])
        goal_pred = model.pred_goal(
            rng=draw_seeds(generator), agent_type=pbatch["ref/agent_type"], map_type=pbatch["ref/map_type"],
            agent_state=pbatch["ref/agent_state"], **feats["input"],
        )
    latent_post = model.latent(posterior=True, rng=draw_seeds(generator), **feats["latent_post"])
    latent_prior = model.latent(posterior=False, rng=draw_seeds(generator), **feats["latent_prior"])
    use_prior = torch.rand((), generator=generator).item() < cfg.p_training_rollout_prior
    mask_tf = teacher_forcing_mask(tf_cfg_to_sim(cfg.tf_training), pbatch["gt/valid"], current_epoch, generator)
    buf = reactive_replay(
        cfg, model, pbatch, feats["input"], latent_prior if use_prior else latent_post, goal_gt, goal_valid,
        mask_tf, generator=generator, deterministic_latent=False,
        deterministic_action=cfg.training_deterministic_action, training=True,
    )
    return training_loss(
        cfg.training_metrics, pred_valid=buf.valid, diffbar_rewards_valid=buf.diffbar_rewards_valid,
        diffbar_rewards=buf.diffbar_rewards, override_masks=buf.override_masks,
        agent_role=pbatch["ref/agent_role"], goal_valid=goal_valid, goal_pred=goal_pred, goal_gt=goal_gt,
        latent_post=latent_post, latent_prior=latent_prior, step_start=cfg.time_step_sim_start,
        generator=generator,
    )
