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
every rank computes the same metrics.

`render_validation_media` writes the validation media of the first
`n_video_batch` batches (the JAX package's file names under `out_dir`): the
reactive replay's video, the joint futures' videos, the SDC's map-attention
video and its destination-probability image. Its device side,
`_vis_device_step`, replays with attention collection (the plain attention
core, as in JAX), so the as2pl of that replay launches no kernel. Without
`cv2` it writes nothing, does no device work and says so.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

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


def _reactive_replay(cfg: ExperimentConfig, model: TrafficBots, batch: Batch, feats, collect_attention: bool = False):
    """Validation's reactive replay: the posterior latent, GT goals, a
    deterministic latent and action. -> (the rollout, goal_gt, goal_valid,
    latent_post)."""
    goal_gt = goal_valid = None
    if cfg.model.goal_manager.goal_attr_mode != "dummy":
        goal_gt, goal_valid = O.get_gt_goal(cfg, batch["input/agent_valid"], batch["gt/goal"], batch["gt/dest"])
    latent_post = model.latent(posterior=True, **feats["latent_post"])
    mask_tf = teacher_forcing_mask(O.tf_cfg_to_sim(cfg.tf_reactive_replay), batch["gt/valid"])
    buf = O.reactive_replay(
        cfg, model, batch, feats["input"], latent_post, goal_gt, goal_valid, mask_tf,
        deterministic_latent=True, deterministic_action=True, collect_attention=collect_attention,
    )
    return buf, goal_gt, goal_valid, latent_post


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
    buf_rr, goal_gt, goal_valid, latent_post = _reactive_replay(cfg, model, batch, feats)
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


@torch.no_grad()
def _vis_device_step(
    cfg: ExperimentConfig, model: TrafficBots, batch: Batch, generator: Optional[torch.Generator] = None,
):
    """The media's device side: the reactive replay with attention collection
    (posterior latent, GT goals, deterministic latent and action), the
    destination probabilities of the goal head ("dest" goals), and the K
    joint futures with the prior latent, `generator` drawing their samples
    as in `validation_device_step`, with their scores.
    -> (replay, dest_probs [B, A, P] or None, joint futures, scores [B, A, K])."""
    batch, feats, goal_pred, latent_prior = _encode(cfg, model, batch)
    buf, _, goal_valid, _ = _reactive_replay(cfg, model, batch, feats, collect_attention=True)
    dest_probs = goal_pred.probs if cfg.model.goal_manager.goal_attr_mode == "dest" else None
    buf_jf, _, goal_logp = O.joint_future_pred(
        cfg, model, batch, feats["input"], latent_prior, goal_pred, goal_valid, generator
    )
    jf_scores = torch.exp(buf_jf.latent_log_probs[..., 0] + goal_logp)
    return buf, dest_probs, buf_jf, jf_scores


def render_validation_media(
    cfg: ExperimentConfig, model: TrafficBots, val_iter_fn: Callable[[], Iterator[Dict[str, np.ndarray]]],
    generator: torch.Generator, out_dir: str,
) -> List[str]:
    """Prediction videos, attention videos and destination-probability
    images of the first `cfg.n_video_batch` validation batches, on the
    model's device -> the written paths. Each batch's draws come from a
    generator seeded by the next number of `generator` (a CPU generator), as
    the JAX package splits its key per batch. A batch's scenes render on
    threads of their own, one a scene (the host's drawing and encoding; the
    files and their order as rendered one by one). Without `cv2` it returns
    [] before any device work."""
    from .utils.vis import _HAS_CV2, VisScene

    if not _HAS_CV2:
        print("validation media: cv2 is not installed, no media written")
        return []
    device = next(model.parameters()).device

    def host(x):
        return x.cpu().numpy()

    paths: List[str] = []
    for batch_idx, batch_np in enumerate(val_iter_fn()):
        if batch_idx >= cfg.n_video_batch:
            break
        batch = to_torch({k: v for k, v in batch_np.items() if not isinstance(v, list)}, device)
        g = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))
        buf, dest_probs, buf_jf, jf_scores = _vis_device_step(cfg, model, batch, g)
        valid, preds = host(buf.valid), host(buf.preds)
        violations = [host(v).astype(bool) for v in buf.violations.values()]
        attn_pl = host(buf.attn["attn_pl"]) if buf.attn and "attn_pl" in buf.attn else None
        valid_jf, preds_jf = host(buf_jf.valid), host(buf_jf.preds)
        violations_jf = [host(v).astype(bool) for v in buf_jf.violations.values()]
        jf_scores = host(jf_scores)
        dest_probs = None if dest_probs is None else host(dest_probs)
        fs, fs_jf = buf.step_future_start, buf_jf.step_future_start

        def scene_media(idx: int) -> List[str]:
            out: List[str] = []
            scene = VisScene(
                batch_np["map/valid"][idx], batch_np["map/type"][idx],
                batch_np["map/pos"][idx], batch_np["map/boundary"][idx],
            )
            episode = {k: batch_np[k][idx] for k in (
                "agent/valid", "agent/pos", "agent/yaw_bbox", "agent/size", "agent/type", "agent/role")}
            for k in ("tl_stop/valid", "tl_stop/pos", "tl_stop/state"):
                if k in batch_np:
                    episode[k] = batch_np[k][idx]
            # rollout outputs are [A, S, ...]; the videos take step-major [S, A, ...]
            viol = np.zeros_like(valid[idx], dtype=bool)
            for v in violations:
                viol |= v[idx]
            prediction = {
                "agent/valid": valid[idx].swapaxes(0, 1)[fs:],
                "agent/pos": preds[idx, :, :, :2].swapaxes(0, 1)[fs:],
                "agent/yaw_bbox": preds[idx, :, :, 2:3].swapaxes(0, 1)[fs:],
                "violations": viol.swapaxes(0, 1)[fs:],
            }
            tag = f"{batch_idx}-{idx}"
            out.append(scene.save_prediction_video(
                os.path.join(out_dir, f"reactive_replay_{tag}.mp4"),
                episode, prediction, step_current=cfg.time_step_current,
            ))
            # the joint futures ([B, A, K, S, ...]): every K for the first
            # batch, K = 0 for the others
            k_to_log = valid_jf.shape[2] if batch_idx == 0 else 1
            for kf in range(k_to_log):
                viol_jf = np.zeros_like(valid_jf[idx, :, kf], dtype=bool)
                for v in violations_jf:
                    viol_jf |= v[idx, :, kf]
                pred_jf = {
                    "agent/valid": valid_jf[idx, :, kf].swapaxes(0, 1)[fs_jf:],
                    "agent/pos": preds_jf[idx, :, kf, :, :2].swapaxes(0, 1)[fs_jf:],
                    "agent/yaw_bbox": preds_jf[idx, :, kf, :, 2:3].swapaxes(0, 1)[fs_jf:],
                    "violations": viol_jf.swapaxes(0, 1)[fs_jf:],
                }
                score = float(np.max(jf_scores[idx, :, kf]))
                out.append(scene.save_prediction_video(
                    os.path.join(out_dir, f"joint_future_K{kf}_{tag}.mp4"),
                    episode, pred_jf, step_current=cfg.time_step_current,
                    title=f"joint_future K={kf} score={score:.3f}",
                ))
            sdc = int(np.argmax(batch_np["agent/role"][idx, :, 0]))
            if attn_pl is not None:
                out.append(scene.save_attention_video(
                    os.path.join(out_dir, f"attn_pl_{tag}.mp4"),
                    batch_np["map/valid"][idx], batch_np["map/pos"][idx],
                    valid[idx].swapaxes(0, 1), preds[idx, :, :, :2].swapaxes(0, 1),
                    preds[idx, :, :, 2].swapaxes(0, 1), batch_np["agent/size"][idx],
                    attn_pl[idx], agent_idx=sdc,
                ))
            if dest_probs is not None:
                out.append(scene.save_dest_prob_image(
                    os.path.join(out_dir, f"dest_prob_{tag}.png"),
                    batch_np["map/valid"][idx], batch_np["map/pos"][idx], dest_probs[idx], agent_idx=sdc,
                ))
            return out

        # one thread a scene: the drawing and the mp4 encoding release the GIL
        n_scene = batch_np["agent/valid"].shape[0]
        with ThreadPoolExecutor(max_workers=min(n_scene, os.cpu_count() or 1)) as pool:
            for scene_paths in pool.map(scene_media, range(n_scene)):
                paths.extend(scene_paths)
    return paths


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
