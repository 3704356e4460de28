"""Validation and test: rollouts -> metric sums -> post-processing -> WOMD metrics and submissions.

Counterpart of `trafficbots_tpu/evaluation_loop.py` on one device.
`validation_device_step` is the device side of a validation batch (the
reactive replay with the posterior latent and GT goals, the K joint futures
with the prior latent and sampled goals, their metric sums and
post-processed predictions); `Validator` adds the sums across batches, packs
the predictions into the WOMD metric layout and the submission payloads on
the host, and `epoch_end` computes the metrics, with `val/loss` =
-mAP(joint_future_pred). `test_step_device` and `pack_test_submission` are
the test action's counterparts (no GT: the history stands in for it).

`Validator` takes the native WOMD metric engine by default, as the JAX
package does. Data parallel (a process group of more than one rank, JAX's
sharded Validator): each rank steps on its slice of the global batch,
drawing the global batch's noise and keeping its rows
(`distributions.global_batch_draws`); `epoch_end` unions every rank's
metric sums and adds them in rank order, the same way on every rank, and
unions the WOMD inputs and the submission payloads before the compute, so
every rank computes the same metrics. Left for a later slice: the media rendering
(`render_validation_media`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import distributions as D
from . import orchestration as O
from .config import ExperimentConfig
from .data.preprocessing import Batch, pre_processing, to_torch
from .eval import metrics as M
from .eval.postprocessing import waymo_post_processing
from .eval.submission import SubWOMD
from .eval.womd import WOMDMetrics
from .models.traffic_bots import TrafficBots
from .parallel import mesh
from .sim.teacher_forcing import teacher_forcing_mask
from .training.loss import training_loss

SUM_KEYS = ("err_rr", "rule_rr", "train_rr", "err_jf", "rule_jf")


def _encode(cfg: ExperimentConfig, model: TrafficBots, batch: Batch):
    """Eval views, the episode encode, the goal head and the prior latent."""
    batch = pre_processing(batch, cfg.model, n_step_hist=cfg.time_step_current + 1, training=False)
    feats = O.encode_episode_features(model, batch)
    goal_pred = None
    if cfg.model.goal_manager.goal_attr_mode != "dummy":
        goal_pred = model.pred_goal(
            agent_type=batch["ref/agent_type"], map_type=batch["ref/map_type"],
            agent_state=batch["ref/agent_state"], **feats["input"],
        )
    latent_prior = model.latent(posterior=False, **feats["latent_prior"])
    return batch, feats, goal_pred, latent_prior


def _post_process_futures(cfg: ExperimentConfig, buf, goal_logp, agent_type):
    return waymo_post_processing(
        cfg.post_processing, valid=buf.valid[:, :, 0].any(dim=-1),
        scores=torch.exp(buf.latent_log_probs[..., 0] + goal_logp),
        trajs=buf.preds[:, :, :, buf.step_future_start:], agent_type=agent_type,
    )


@torch.no_grad()
def validation_device_step(
    cfg: ExperimentConfig, model: TrafficBots, batch: Batch, generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """One validation batch (tensors on the model's device, the
    data.synthetic contract) -> the reactive-replay and joint-future metric
    sums, post-processed predictions and rollout summaries. `generator`
    draws the joint futures' goal and latent samples; the reactive replay
    is deterministic."""
    batch, feats, goal_pred, latent_prior = _encode(cfg, model, batch)
    goal_gt = goal_valid = None
    if cfg.model.goal_manager.goal_attr_mode != "dummy":
        goal_gt, goal_valid = O.get_gt_goal(cfg, batch["input/agent_valid"], batch["gt/goal"], batch["gt/dest"])
    latent_post = model.latent(posterior=True, **feats["latent_post"])

    # reactive replay: posterior latent, GT goal, deterministic
    mask_tf = teacher_forcing_mask(O.tf_cfg_to_sim(cfg.tf_reactive_replay), batch["gt/valid"])
    buf_rr = O.reactive_replay(
        cfg, model, batch, feats["input"], latent_post, goal_gt, goal_valid, mask_tf,
        deterministic_latent=True, deterministic_action=True,
    )
    ss = cfg.time_step_sim_start
    gt_valid_roll = batch["gt/valid"][:, ss:].transpose(1, 2)
    gt_state_roll = batch["gt/state"][:, ss:].transpose(1, 2)
    role, atype = batch["ref/agent_role"], batch["ref/agent_type"]
    err_rr = M.error_metrics_update(buf_rr.valid, buf_rr.preds, gt_valid_roll, gt_state_roll, buf_rr.override_masks, role)
    rule_rr = M.rule_metrics_update(buf_rr.valid, buf_rr.override_masks, buf_rr.violations, atype)
    _, train_m_rr = training_loss(
        cfg.training_metrics, pred_valid=buf_rr.valid, diffbar_rewards_valid=buf_rr.diffbar_rewards_valid,
        diffbar_rewards=buf_rr.diffbar_rewards, override_masks=buf_rr.override_masks, agent_role=role,
        goal_valid=goal_valid, goal_pred=goal_pred, goal_gt=goal_gt, latent_post=latent_post,
        latent_prior=latent_prior, step_start=ss, generator=None,
    )
    fs = buf_rr.step_future_start
    pred_rr = waymo_post_processing(
        cfg.post_processing, valid=buf_rr.valid.any(dim=-1), scores=torch.ones_like(buf_rr.preds[:, :, None, 0, 0]),
        trajs=buf_rr.preds[:, :, None, fs:], agent_type=atype,
    )

    # joint future prediction: prior latent, predicted goal, K futures
    buf_jf, goal_sample, goal_logp = O.joint_future_pred(
        cfg, model, batch, feats["input"], latent_prior, goal_pred, goal_valid, generator
    )
    err_jf = M.error_metrics_update(buf_jf.valid, buf_jf.preds, gt_valid_roll, gt_state_roll, buf_jf.override_masks, role)
    rule_jf = M.rule_metrics_update(buf_jf.valid, buf_jf.override_masks, buf_jf.violations, atype)
    return {
        "err_rr": err_rr, "rule_rr": rule_rr, "train_rr": train_m_rr,
        "err_jf": err_jf, "rule_jf": rule_jf,
        "pred_rr": pred_rr, "pred_jf": _post_process_futures(cfg, buf_jf, goal_logp, atype),
        "goal_sample": goal_sample, "goal_logp": goal_logp,
        "buf_rr_preds": buf_rr.preds, "buf_rr_valid": buf_rr.valid,
        "buf_jf_preds": buf_jf.preds, "buf_jf_valid": buf_jf.valid,
    }


def _sums_to_host(out: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Every metric sum of one step to the host in one copy, fp32 like the
    JAX package's sums."""
    names = [(k, kk) for k in SUM_KEYS for kk in out[k]]
    vals = torch.stack([out[k][kk].float() for k, kk in names]).cpu().numpy()
    sums: Dict[str, Dict[str, np.ndarray]] = {k: {} for k in SUM_KEYS}
    for (k, kk), v in zip(names, vals):
        sums[k][kk] = v
    return sums


class Validator:
    """Host-side accumulation across validation batches and the epoch-end
    compute, on the model's device. Entry point: `step` takes a numpy
    batch and runs on `device` (the card unless the caller asks for the
    CPU; without CUDA it raises). In a process group of more than one rank,
    `step`'s batch is the rank's slice of the global batch."""

    def __init__(self, cfg: ExperimentConfig, model: TrafficBots, use_native_metrics: bool = True,
                 sub_rr: Optional[SubWOMD] = None, sub_jf: Optional[SubWOMD] = None, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.device = O.resolve_device(device)
        self.womd_rr = WOMDMetrics("reactive_replay", cfg.time_step_end, cfg.time_step_current,
                                   cfg.interactive_challenge, use_native=use_native_metrics)
        self.womd_jf = WOMDMetrics("joint_future_pred", cfg.time_step_end, cfg.time_step_current,
                                   cfg.interactive_challenge, use_native=use_native_metrics)
        self.sub_rr = sub_rr or SubWOMD(k_futures=1, activate=False)
        self.sub_jf = sub_jf or SubWOMD(k_futures=cfg.n_joint_future, activate=False)
        self.reset()

    def reset(self):
        self.sums: Dict[str, Dict[str, np.ndarray]] = {k: {} for k in SUM_KEYS}
        self.womd_rr.reset()
        self.womd_jf.reset()
        self.sub_rr.reset()
        self.sub_jf.reset()

    def step(self, batch_np: Dict[str, np.ndarray], generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One validation batch with the model's own weights; `generator`
        (a CPU generator, the same on every rank) draws the joint futures'
        samples. -> `validation_device_step`'s output."""
        batch = to_torch({k: v for k, v in batch_np.items() if not isinstance(v, list)}, self.device)
        with D.global_batch_draws(mesh.rank(), mesh.world_size()):
            out = validation_device_step(self.cfg, self.model, batch, generator)
        for k, v in _sums_to_host(out).items():
            self.sums[k] = M.add_metric_sums(self.sums[k], v)

        # host-side WOMD packing (small arrays)
        mask_pred = batch_np.get("history/agent/role", batch_np["agent/role"])[..., 2]
        object_id = batch_np.get(
            "history/agent/object_id",
            batch_np.get("agent/object_id", np.broadcast_to(
                np.arange(batch_np["agent/valid"].shape[-1]), batch_np["agent/valid"].shape[::2]
            )),
        )
        trajs_rr, scores_rr, trajs_jf, scores_jf = (
            out[p][f"waymo_{n}"].cpu().numpy() for p in ("pred_rr", "pred_jf") for n in ("trajs", "scores")
        )
        # a loader's final batch may repeat scenes to fill it (pad_mask):
        # those rows must not reach the WOMD metrics or the submissions (the
        # metric sums above include them)
        pads = batch_np.get("pad_mask")
        if pads is not None and any(pads):
            keep = ~np.asarray(pads)
            nB = len(pads)
            batch_np = {
                k: (
                    [x for x, m in zip(v, keep) if m]
                    if isinstance(v, list) and len(v) == nB
                    else v[keep]
                    if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == nB
                    else v
                )
                for k, v in batch_np.items()
                if k != "pad_mask"
            }
            trajs_rr, scores_rr = trajs_rr[keep], scores_rr[keep]
            trajs_jf, scores_jf = trajs_jf[keep], scores_jf[keep]
            mask_pred, object_id = mask_pred[keep], object_id[keep]
        self.womd_rr.update(batch_np, trajs_rr, scores_rr)
        self.womd_jf.update(batch_np, trajs_jf, scores_jf)

        if self.sub_rr.activate or self.sub_jf.activate:
            common = dict(
                mask_pred=mask_pred,
                object_id=object_id,
                scenario_center=batch_np.get("scenario_center", np.zeros((mask_pred.shape[0], 2))),
                scenario_yaw=batch_np.get("scenario_yaw", np.zeros(mask_pred.shape[0])),
                scenario_id=batch_np.get(
                    "scenario_id", [str(i) for i in batch_np.get("episode_idx", range(mask_pred.shape[0]))]
                ),
            )
            self.sub_rr.add_to_submissions(trajs_rr, scores_rr, **common)
            self.sub_jf.add_to_submissions(trajs_jf, scores_jf, **common)
        return out

    def epoch_end(self) -> Dict[str, float]:
        """val/loss = -mAP(joint_future_pred), or the reactive replay's
        position error when the WOMD metrics are off (a horizon shorter than
        the challenge's 80 future steps)."""
        # every rank's sums, added in rank order (with one rank, its own)
        sums: Dict[str, Dict[str, np.ndarray]] = {k: {} for k in SUM_KEYS}
        for rank_sums in mesh.allgather_pyobj(self.sums):
            sums = {k: M.add_metric_sums(sums[k], rank_sums[k]) for k in SUM_KEYS}
        out: Dict[str, float] = {}
        out.update(M.error_metrics_compute(sums["err_rr"], "reactive_replay/"))
        out.update(M.rule_metrics_compute(sums["rule_rr"], "reactive_replay/"))
        out.update(M.error_metrics_compute(sums["err_jf"], "joint_future_pred/"))
        out.update(M.rule_metrics_compute(sums["rule_jf"], "joint_future_pred/"))
        tm = sums["train_rr"]
        for name in ("vae_kl", "diffbar_reward", "goal_loss"):
            if f"{name}_sum" in tm:
                out[f"reactive_replay/{name}"] = float(tm[f"{name}_sum"]) / max(float(tm[f"{name}_count"]), 1.0)
        # the WOMD inputs and the submission payloads of every rank, before
        # the compute and rank 0's write
        for m in (self.womd_rr, self.womd_jf, self.sub_rr, self.sub_jf):
            m.sync()
        out.update(self.womd_rr.compute())
        out.update(self.womd_jf.compute())
        if "joint_future_pred/mean_average_precision" in out:
            out["val/loss"] = -out["joint_future_pred/mean_average_precision"]
        else:
            out["val/loss"] = out.get("reactive_replay/err/pos_meter", 0.0)
        return out


@torch.no_grad()
def test_step_device(
    cfg: ExperimentConfig, model: TrafficBots, batch: Batch, generator: Optional[torch.Generator] = None,
) -> Dict[str, Optional[torch.Tensor]]:
    """Test: no GT. The history stands in for the agent and traffic-light
    keys; prior latent, predicted goal, K futures -> post-processed
    predictions for the submission."""
    b = dict(batch)
    for k in ("valid", "vel", "acc", "yaw_rate", "pos", "yaw_bbox", "spd", "size", "type", "z"):
        b[f"agent/{k}"] = b[f"history/agent/{k}"]
    for k in ("valid", "pos", "state", "dir"):
        b[f"tl_stop/{k}"] = b[f"history/tl_stop/{k}"]
    pb, feats, goal_pred, latent_prior = _encode(cfg, model, b)
    goal_valid = pb["input/agent_valid"].any(dim=1)
    buf, _, goal_logp = O.joint_future_pred(cfg, model, pb, feats["input"], latent_prior, goal_pred, goal_valid, generator)
    return _post_process_futures(cfg, buf, goal_logp, pb["ref/agent_type"])


def pack_test_submission(sub: SubWOMD, pred, batch_np: Dict[str, np.ndarray]) -> None:
    """Pack one test batch's predictions (`test_step_device`'s tensors) into
    the submission accumulator,
    without the rows a loader repeated to fill its final batch (`pad_mask`)."""
    mask_pred = np.asarray(batch_np["history/agent/role"])[..., 2]
    n_scene, n_agent = mask_pred.shape
    keep = ~np.asarray(batch_np.get("pad_mask", [False] * n_scene), bool)
    sids = batch_np.get("scenario_id", [str(s) for s in batch_np.get("episode_idx", range(n_scene))])
    sub.add_to_submissions(
        pred["waymo_trajs"].cpu().numpy()[keep],
        pred["waymo_scores"].cpu().numpy()[keep],
        mask_pred=mask_pred[keep],
        object_id=np.asarray(
            batch_np.get("history/agent/object_id", np.broadcast_to(np.arange(n_agent), (n_scene, n_agent)))
        )[keep],
        scenario_center=np.asarray(batch_np.get("scenario_center", np.zeros((n_scene, 2))))[keep],
        scenario_yaw=np.asarray(batch_np.get("scenario_yaw", np.zeros(n_scene)))[keep],
        scenario_id=[s for s, k in zip(sids, keep) if k],
    )
