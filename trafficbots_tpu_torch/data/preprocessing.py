"""Scene-centric views, input featurization and latent views in PyTorch.

Counterpart of `trafficbots_tpu/data/preprocessing.py`, eval side. Each
stage maps a dict of tensors to a dict with new keys under the reference
contract's prefixes ("sc/", "gt/", "ref/", "input/", "latent_prior/",
"latent_post/"), taking the "history/" prefix as the JAX package does when
`training=False`. Nothing here carries gradients.

The training-only branches (history dropout, the SE(2) perturbation of the
latent inputs) belong to the training slice of the port and raise
`NotImplementedError` until it lands.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..geometry import pose_pe

Tensor = torch.Tensor
Batch = Dict[str, Tensor]

_TRAINING_SLICE = "the training slice of the PyTorch port (slice B)"


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
        for k in ("cmd", "goal", "dest"):
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


def sc_input(batch: Batch, cfg: ModelConfig, n_step_hist: int, training: bool) -> Batch:
    """Build input/ features."""
    if training and 0 < cfg.dropout_p_history <= 1.0:
        raise NotImplementedError(f"history dropout belongs to {_TRAINING_SLICE}")
    out = dict(batch)
    out["input/agent_valid"] = batch["sc/agent_valid"]
    out["input/tl_valid"] = batch["sc/tl_valid"]
    out["input/map_valid"] = batch["sc/map_valid"]

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


def sc_latent(batch: Batch, cfg: ModelConfig, training: bool) -> Batch:
    """Build latent_prior/ and latent_post/ views (no perturbation)."""
    if training and cfg.perturb_input_to_latent:
        raise NotImplementedError(f"the latent-input SE(2) perturbation belongs to {_TRAINING_SLICE}")
    if training and 0 < cfg.dropout_p_history <= 1.0:
        raise NotImplementedError(f"history dropout belongs to {_TRAINING_SLICE}")
    out = dict(batch)
    gt_available = "agent/valid" in batch

    for kind in ("map", "tl", "agent"):
        for k in ("valid", "pos", "attr", "pe"):
            out[f"latent_prior/{kind}_{k}"] = out[f"input/{kind}_{k}"]
    if not gt_available:
        return out

    for k in ("valid", "pos", "attr", "pe"):
        out[f"latent_post/map_{k}"] = out[f"latent_prior/map_{k}"]

    tl_pos = batch["tl_stop/pos"]
    out["latent_post/tl_valid"] = batch["tl_stop/valid"]
    out["latent_post/tl_pos"] = tl_pos
    out["latent_post/tl_attr"] = batch["tl_stop/state"].to(tl_pos.dtype)
    out["latent_post/tl_pe"] = pose_pe(tl_pos, batch["tl_stop/dir"], cfg.pose_pe_tl, cfg.pe_dim)

    out["latent_post/agent_valid"] = batch["agent/valid"]
    out["latent_post/agent_pos"] = batch["agent/pos"]
    out["latent_post/agent_attr"] = _agent_attr(
        batch["agent/vel"], batch["agent/spd"], batch["agent/yaw_rate"],
        batch["agent/acc"], batch["agent/size"], batch["agent/type"],
    )
    out["latent_post/agent_pe"] = pose_pe(
        batch["agent/pos"], batch["agent/yaw_bbox"], cfg.pose_pe_agent, cfg.pe_dim
    )
    return out


def pre_processing(
    batch: Batch, cfg: ModelConfig, n_step_hist: int = 11, training: bool = False
) -> Batch:
    """scene_centric -> sc_input -> sc_latent."""
    batch = scene_centric(batch, n_step_hist, training)
    batch = sc_input(batch, cfg, n_step_hist, training)
    return sc_latent(batch, cfg, training)


def extract(batch: Batch, prefix: str) -> Batch:
    """Strip a 'prefix/' namespace, e.g. extract(batch, 'input')."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in batch.items() if k.startswith(p)}
