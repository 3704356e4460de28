"""Scene-centric views, input featurization and latent views in PyTorch.

Counterpart of `trafficbots_tpu/data/preprocessing.py`. Each stage maps a
dict of tensors to a dict with new keys under the reference contract's
prefixes ("sc/", "gt/", "ref/", "input/", "latent_prior/", "latent_post/"),
taking the "history/" prefix as the JAX package does when
`training=False`. Nothing here carries gradients.

The training-input augmentations, both off by default, draw from the
`generator` handed to `pre_processing`, through
`distributions.standard_uniform`, in the JAX package's order:
  - history dropout (`dropout_p_history`): Bernoulli keep masks over the
    input view's agent steps but the last, traffic lights and map
    polylines, then over each latent view's traffic lights and agents;
  - the SE(2) perturbation of the latent inputs (`perturb_input_to_latent`):
    a random yaw and offset a scene re-express the prior view's map,
    traffic lights and agents in another frame, and the `latent_perturbed`
    marker tells `orchestration.encode_episode_features` to encode the map
    once a view.
With both off nothing is drawn.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import distributions as D
from ..config import ModelConfig
from ..geometry import dir2local, pos2local, pose_pe, rad2local, rad2rot

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def to_torch(batch_np: Dict[str, np.ndarray], device) -> Batch:
    """numpy batch (data.synthetic contract) -> tensors on `device`.

    int64 and bool arrays keep their dtypes, float64 scenario metadata
    stays float64, fp32 stays fp32.
    """
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in batch_np.items()}


def scene_centric(batch: Batch, n_step_hist: int, training: bool) -> Batch:
    """Slice history views and build sc/, gt/, ref/ keys."""
    out = dict(batch)
    prefix = "" if training else "history/"

    for k in ("valid", "pos", "z", "vel", "spd", "acc", "yaw_bbox", "yaw_rate"):
        out[f"sc/agent_{k}"] = batch[f"{prefix}agent/{k}"][:, :n_step_hist]
    for k in ("type", "role", "size"):
        out[f"sc/agent_{k}"] = batch[f"{prefix}agent/{k}"]

    if "agent/valid" in batch:
        # the test split has no future: no command, goal or destination
        # (the JAX package's test step fails on an h5 test batch here)
        for k in ("cmd", "goal", "dest"):
            if f"agent/{k}" in batch:
                out[f"gt/{k}"] = batch[f"agent/{k}"]
        for k in ("valid", "spd", "pos", "vel", "yaw_bbox"):
            out[f"gt/{k}"] = batch[f"agent/{k}"]
        out["gt/state"] = torch.cat([out["gt/pos"], out["gt/yaw_bbox"], out["gt/spd"]], dim=-1)

    for k in ("valid", "type", "pos", "dir"):
        out[f"sc/map_{k}"] = batch[f"map/{k}"]
    for k in ("valid", "state", "pos", "dir"):
        out[f"sc/tl_{k}"] = batch[f"{prefix}tl_stop/{k}"][:, :n_step_hist]

    if not training and "history/agent_no_sim/valid" in batch:
        for k in ("valid", "pos", "z", "vel", "spd", "yaw_bbox"):
            out[f"sc/agent_no_sim_{k}"] = batch[f"history/agent_no_sim/{k}"][:, :n_step_hist]
        for k in ("type", "size"):
            out[f"sc/agent_no_sim_{k}"] = batch[f"history/agent_no_sim/{k}"]

    out["ref/agent_type"] = batch[f"{prefix}agent/type"]
    out["ref/agent_role"] = batch[f"{prefix}agent/role"]
    out["ref/map_type"] = batch["map/type"]
    out["ref/agent_state"] = torch.cat(
        [out["sc/agent_pos"], out["sc/agent_yaw_bbox"], out["sc/agent_spd"]], dim=-1
    )
    return out


def agent_attr_and_pe(
    cfg: ModelConfig,
    agent_pos: Tensor,
    agent_yaw_bbox: Tensor,
    agent_vel: Tensor,
    agent_spd: Tensor,
    agent_yaw_rate: Tensor,
    agent_acc: Tensor,
    agent_size: Tensor,
    agent_type: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Per-step agent featurizer used inside the rollout."""
    attr = torch.cat(
        [agent_vel, agent_spd, agent_yaw_rate, agent_acc, agent_size, agent_type.to(agent_vel.dtype)],
        dim=-1,
    )
    pe = pose_pe(agent_pos, agent_yaw_bbox, cfg.pose_pe_agent, cfg.pe_dim)
    return attr, pe


def _agent_attr(vel, spd, yaw_rate, acc, size, atype) -> Tensor:
    """[B, T, A, 11]: per-step kinematics plus the broadcast size and type."""
    n_scene, n_step, n_agent = vel.shape[:3]
    return torch.cat(
        [
            vel, spd, yaw_rate, acc,
            size[:, None].expand(n_scene, n_step, n_agent, 3),
            atype[:, None].expand(n_scene, n_step, n_agent, 3).to(vel.dtype),
        ],
        dim=-1,
    )


def map_attr(map_type: Tensor, n_pl_node: int, dtype=torch.float32) -> Tensor:
    """[B, P, N, n_type + N]: the polyline type one-hot next to the node
    one-hot. The JAX package feeds the map MLP this pair factored to save TPU
    memory; the port builds the plain attribute."""
    n_scene, n_pl, _ = map_type.shape
    node = torch.eye(n_pl_node, dtype=dtype, device=map_type.device)
    return torch.cat(
        [
            map_type[:, :, None].to(dtype).expand(n_scene, n_pl, n_pl_node, map_type.shape[-1]),
            node[None, None].expand(n_scene, n_pl, n_pl_node, n_pl_node),
        ],
        dim=-1,
    )


def _history_dropout(cfg: ModelConfig, training: bool) -> bool:
    return training and 0 < cfg.dropout_p_history <= 1.0


def _keep_mask(shape, cfg: ModelConfig, device, generator: Optional[torch.Generator]) -> Tensor:
    """Bernoulli(1 - dropout_p_history) keep mask, `uniform < p` as
    jax.random.bernoulli draws it (p rounded to fp32 first, as there)."""
    if generator is None:
        raise ValueError("history dropout draws its masks from a generator; pass one to pre_processing")
    keep = torch.tensor(1.0 - cfg.dropout_p_history, dtype=torch.float32, device=device)
    return D.standard_uniform(shape, torch.float32, device, generator) < keep


def _drop_but_last(valid: Tensor, cfg: ModelConfig, generator) -> Tensor:
    """History dropout over every step of [B, T, ...] but the last."""
    keep = _keep_mask(valid[:, :-1].shape, cfg, valid.device, generator)
    return torch.cat([valid[:, :-1] & keep, valid[:, -1:]], dim=1)


def _uniform(shape, bound: float, dtype, device, generator: Optional[torch.Generator]) -> Tensor:
    """Uniform on [-bound, bound), max(lo, u * (hi - lo) + lo) in `dtype`,
    as jax.random.uniform computes it."""
    if generator is None:
        raise ValueError("the latent-input perturbation draws from a generator; pass one to pre_processing")
    lo = torch.tensor(-bound, dtype=dtype, device=device)
    hi = torch.tensor(bound, dtype=dtype, device=device)
    u = D.standard_uniform(shape, dtype, device, generator)
    return torch.maximum(lo, u * (hi - lo) + lo)


def sc_input(
    batch: Batch, cfg: ModelConfig, n_step_hist: int, training: bool,
    generator: Optional[torch.Generator] = None,
) -> Batch:
    """Build input/ features; under history dropout the agents' steps but the
    last, the traffic lights and the map polylines are dropped."""
    out = dict(batch)
    agent_valid, tl_valid, map_valid = batch["sc/agent_valid"], batch["sc/tl_valid"], batch["sc/map_valid"]
    if _history_dropout(cfg, training):
        agent_valid = _drop_but_last(agent_valid, cfg, generator)
        tl_valid = tl_valid & _keep_mask(tl_valid.shape, cfg, tl_valid.device, generator)
        map_valid = map_valid & _keep_mask(map_valid.shape, cfg, map_valid.device, generator)
    out["input/agent_valid"] = agent_valid
    out["input/tl_valid"] = tl_valid
    out["input/map_valid"] = map_valid

    out["input/agent_pos"] = batch["sc/agent_pos"]
    out["input/agent_attr"] = _agent_attr(
        batch["sc/agent_vel"], batch["sc/agent_spd"], batch["sc/agent_yaw_rate"],
        batch["sc/agent_acc"], batch["sc/agent_size"], batch["sc/agent_type"],
    )
    out["input/agent_pe"] = pose_pe(
        batch["sc/agent_pos"], batch["sc/agent_yaw_bbox"], cfg.pose_pe_agent, cfg.pe_dim
    )

    n_pl_node = batch["sc/map_valid"].shape[2]
    out["input/map_pos"] = batch["sc/map_pos"][:, :, 0]
    out["input/map_attr"] = map_attr(batch["sc/map_type"], n_pl_node, batch["sc/map_pos"].dtype)
    out["input/map_pe"] = pose_pe(batch["sc/map_pos"], batch["sc/map_dir"], cfg.pose_pe_map, cfg.pe_dim)

    out["input/tl_pos"] = batch["sc/tl_pos"]
    out["input/tl_attr"] = batch["sc/tl_state"].to(batch["sc/tl_pos"].dtype)
    out["input/tl_pe"] = pose_pe(batch["sc/tl_pos"], batch["sc/tl_dir"], cfg.pose_pe_tl, cfg.pe_dim)
    return out


def sc_latent(
    batch: Batch, cfg: ModelConfig, training: bool, generator: Optional[torch.Generator] = None,
) -> Batch:
    """Build latent_prior/ and latent_post/ views. In training, under
    `perturb_input_to_latent`, both views are re-expressed in a random frame
    a scene (yaw within perturb_max_rad, offset within perturb_max_meter),
    and the prior view gets history dropout of its own (else it is the
    input view); the posterior view (the whole episode) always gets its own
    traffic-light and agent dropout."""
    out = dict(batch)
    gt_available = "agent/valid" in batch
    drop = _history_dropout(cfg, training)
    perturb = training and cfg.perturb_input_to_latent

    if perturb:
        # the latent views see another map than the input view's: the map
        # encode is not shared (orchestration.encode_episode_features)
        pos = batch["sc/agent_pos"]
        n_scene = pos.shape[0]
        out["latent_perturbed"] = torch.ones((), dtype=torch.bool, device=pos.device)
        rand_yaw = _uniform((n_scene,), cfg.perturb_max_rad, pos.dtype, pos.device, generator)
        rand_pos = _uniform((n_scene, 2), cfg.perturb_max_meter, pos.dtype, pos.device, generator)
        r_yaw = rand_yaw[:, None, None]
        r_rot = rad2rot(rand_yaw)[:, None]
        r_pos = rand_pos[:, None, None, :]

    # ---- map
    if perturb:
        map_pos = pos2local(batch["sc/map_pos"], r_pos, r_rot)
        map_dir = dir2local(batch["sc/map_dir"], r_rot)
        out["latent_prior/map_pos"] = map_pos[:, :, 0]
        out["latent_prior/map_attr"] = batch["input/map_attr"]
        out["latent_prior/map_pe"] = pose_pe(map_pos, map_dir, cfg.pose_pe_map, cfg.pe_dim)
        out["latent_prior/map_valid"] = batch["sc/map_valid"]
    else:
        for k in ("valid", "pos", "attr", "pe"):
            out[f"latent_prior/map_{k}"] = out[f"input/map_{k}"]
    if gt_available:
        for k in ("valid", "pos", "attr", "pe"):
            out[f"latent_post/map_{k}"] = out[f"latent_prior/map_{k}"]

    # ---- traffic lights
    def tl_view(valid, pos, direction, state, perturbed):
        if drop:
            valid = valid & _keep_mask(valid.shape, cfg, valid.device, generator)
        if perturbed:
            pos = pos2local(pos, r_pos, r_rot)
            direction = dir2local(direction, r_rot)
        return valid, pos, state.to(pos.dtype), pose_pe(pos, direction, cfg.pose_pe_tl, cfg.pe_dim)

    def put(prefix, kind, view):
        for k, v in zip(("valid", "pos", "attr", "pe"), view):
            out[f"{prefix}/{kind}_{k}"] = v

    if perturb:
        put("latent_prior", "tl", tl_view(
            batch["sc/tl_valid"], batch["sc/tl_pos"], batch["sc/tl_dir"], batch["sc/tl_state"], True))
    else:
        for k in ("valid", "pos", "attr", "pe"):
            out[f"latent_prior/tl_{k}"] = out[f"input/tl_{k}"]
    if gt_available:
        put("latent_post", "tl", tl_view(
            batch["tl_stop/valid"], batch["tl_stop/pos"], batch["tl_stop/dir"], batch["tl_stop/state"], perturb))

    # ---- agents
    def agent_view(prefix, perturbed, drop_last=False):
        valid, pos, vel, yaw = (batch[f"{prefix}{k}"] for k in ("valid", "pos", "vel", "yaw_bbox"))
        if drop:
            if drop_last:
                valid = _drop_but_last(valid, cfg, generator)
            else:
                valid = valid & _keep_mask(valid.shape, cfg, valid.device, generator)
        if perturbed:
            pos = pos2local(pos, r_pos, r_rot)
            vel = dir2local(vel, r_rot)
            yaw = rad2local(yaw[..., 0], r_yaw[..., 0], cast=False)[..., None]
        attr = _agent_attr(vel, *(batch[f"{prefix}{k}"] for k in ("spd", "yaw_rate", "acc", "size", "type")))
        return valid, pos, attr, pose_pe(pos, yaw, cfg.pose_pe_agent, cfg.pe_dim)

    if perturb:
        put("latent_prior", "agent", agent_view("sc/agent_", True, drop_last=True))
    else:
        for k in ("valid", "pos", "attr", "pe"):
            out[f"latent_prior/agent_{k}"] = out[f"input/agent_{k}"]
    if gt_available:
        put("latent_post", "agent", agent_view("agent/", perturb))
    return out


def pre_processing(
    batch: Batch, cfg: ModelConfig, n_step_hist: int = 11, training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Batch:
    """scene_centric -> sc_input -> sc_latent. `generator` (a CPU generator)
    draws the training-input augmentations, input view first, and is read
    only when one is on."""
    batch = scene_centric(batch, n_step_hist, training)
    batch = sc_input(batch, cfg, n_step_hist, training, generator)
    return sc_latent(batch, cfg, training, generator)


def extract(batch: Batch, prefix: str) -> Batch:
    """Strip a 'prefix/' namespace, e.g. extract(batch, 'input')."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in batch.items() if k.startswith(p)}
