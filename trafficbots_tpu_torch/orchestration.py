"""Episode-level orchestration: model construction, episode encoding, reactive replay.

Counterpart of `trafficbots_tpu/orchestration.py` up to `reactive_replay`,
plus `eval_rollout`, the port's main path: the counterpart of the program
`bench.py` times,

    pre_processing -> encode_episode_features -> posterior latent
    -> get_gt_goal -> teacher_forcing_mask -> reactive_replay (91 steps)

in eval mode with a deterministic latent and action.

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
from .sim import rules as RU
from .sim.dynamics import make_dynamics_params
from .sim.rollout import RolloutOutput, rollout, rule_config
from .sim.teacher_forcing import TeacherForcingConfig, teacher_forcing_mask

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


def encode_map_chunked(model: TrafficBots, batch: Batch, chunk: int) -> Tuple[Tensor, Tensor]:
    """The episode map encode over scene chunks of `chunk`, each with its own
    PE and attributes, so the [chunk, P, N, *] featurization temporaries are
    the largest that exist. Per-scene results do not depend on the chunk."""
    mcfg = model.cfg
    feats, valids = [], []
    n_scene, _, n_node = batch["sc/map_valid"].shape
    for s in range(0, n_scene, chunk):
        sl = slice(s, s + chunk)
        pos = batch["sc/map_pos"][sl]
        pe = pose_pe(pos, batch["sc/map_dir"][sl], mcfg.pose_pe_map, mcfg.pe_dim)
        attr = map_attr(batch["sc/map_type"][sl], n_node, pos.dtype)
        f, v = model.map_only(batch["input/map_valid"][sl], attr, pe)
        feats.append(f)
        valids.append(v)
    return torch.cat(feats), torch.cat(valids)


def encode_episode_features(
    model: TrafficBots, batch: Batch, views: Iterable[str] = VIEWS,
) -> Dict[str, Dict[str, Tensor]]:
    """Encode the episode views; the map is encoded once (in chunks of
    `map_encode_chunk` scenes when that is > 0) and shared by every view,
    as the JAX package does in eval when the views see one map."""
    chunk = model.cfg.map_encode_chunk
    n_scene = batch["sc/map_valid"].shape[0]
    shared_map = encode_map_chunked(model, batch, chunk if chunk > 0 else n_scene)
    out = {}
    for prefix in views:
        if f"{prefix}/agent_valid" not in batch:
            continue
        view = extract(batch, prefix)
        view["map_feature"], view["map_feature_valid"] = shared_map
        out[prefix] = model.encode_input_features(**view)
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
        step_start=cfg.time_step_sim_start, step_end=cfg.time_step_end,
    )


def get_gt_goal(cfg: ExperimentConfig, agent_valid, gt_goal, gt_dest):
    return GM.get_gt_goal(cfg.model.goal_manager, agent_valid, gt_goal, gt_dest)


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
