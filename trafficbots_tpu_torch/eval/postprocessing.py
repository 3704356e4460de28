"""WOMD post-processing: K rollout samples -> <= k_pred scored predictions.

Counterpart of `trafficbots_tpu/eval/postprocessing.py`, every branch
batched over scenes and agents: top-k, greedy MTR-NMS, the k-means EM
aggregation with the exact empty-cluster split order, MPA score
suppression, and the temperature softmax. The greedy loops stay loops over
k_pred (6 iterations). The default config (K = k_pred = 6, no thresholds)
reaches only the normalisation and the temperature softmax; users switch the
other branches on from the command line.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import PostProcessingConfig

Tensor = torch.Tensor


def _pairwise_dist(xy: Tensor, use_ade: bool) -> Tensor:
    """xy [S, A, P, T, 2] -> [S, A, P, P] mean-ADE or FDE distance."""
    if use_ade:
        return torch.linalg.norm(xy[:, :, :, None] - xy[:, :, None, :], dim=-1).mean(dim=-1)
    last = xy[:, :, :, -1]
    return torch.linalg.norm(last[:, :, :, None] - last[:, :, None, :], dim=-1)


def _type_thresh(agent_type: Tensor, thresh: Sequence[float]) -> Tensor:
    t = torch.tensor(thresh, dtype=torch.float32, device=agent_type.device)
    return torch.einsum("sat,t->sa", agent_type.float(), t)


def _take_modes(trajs: Tensor, scores: Tensor, idx: Tensor):
    """trajs [S, A, P, T, d], scores [S, A, P], idx [S, A, k] -> the chosen
    modes' trajectories and normalised scores."""
    t_idx = idx[:, :, :, None, None].expand(-1, -1, -1, *trajs.shape[3:])
    trajs_k = torch.gather(trajs, 2, t_idx)
    scores_k = torch.gather(scores, 2, idx)
    return trajs_k, scores_k / scores_k.sum(dim=-1, keepdim=True)


def _row(within: Tensor, idx: Tensor) -> Tensor:
    """within [S, A, P, P], idx [S, A] -> within[s, a, idx[s, a], :]."""
    return torch.gather(within, 2, idx[:, :, None, None].expand(-1, -1, 1, within.shape[-1]))[:, :, 0]


def traj_topk(trajs: Tensor, scores: Tensor, k_pred: int):
    _, idx = torch.topk(scores, k_pred, dim=-1)
    return _take_modes(trajs, scores, idx)


def mtr_nms(trajs, scores, k_pred, type_thresh, use_ade, agent_type):
    """Greedy NMS that multiplies the scores near each pick by 0.01."""
    thresh = _type_thresh(agent_type, type_thresh)[:, :, None, None]
    within = _pairwise_dist(trajs[..., :2], use_ade) < thresh  # [S, A, P, P]
    sc = scores
    idxs = []
    for _ in range(k_pred):
        idx = sc.argmax(dim=-1)
        idxs.append(idx)
        sc = sc * torch.where(_row(within, idx), 0.01, 1.0)
        sc = sc - F.one_hot(idx, sc.shape[-1]).to(sc.dtype) * (sc.max() + 1.0)
    return _take_modes(trajs, scores, torch.stack(idxs, dim=-1))


def _split_largest_into_empty(assign: Tensor, k_pred: int) -> Tensor:
    """Exact empty-cluster reassignment: for every cluster that came out of
    the E-step empty, in k-ascending order, move the first floor(n / 2)
    members (pred index ascending) of the currently largest cluster (the
    first on ties) into it. The JAX function's docstring argues why a loop
    over k that acts on all cells at once is the reference's order."""
    empty0 = assign.sum(dim=2) == 0  # [S, A, K]
    for k in range(k_pred):
        counts = assign.sum(dim=2)
        max_i = counts.argmax(dim=-1)  # [S, A], the first max
        n_max = torch.gather(counts, 2, max_i[:, :, None])  # [S, A, 1]
        member = torch.gather(assign, 3, max_i[:, :, None, None].expand(-1, -1, assign.shape[2], 1))[..., 0]
        rank = member.cumsum(dim=-1)
        split = (member > 0) & (rank <= torch.floor(n_max / 2.0))
        do = (empty0[:, :, k][:, :, None] & split)[..., None].to(assign.dtype)
        one_k = F.one_hot(torch.full_like(max_i, k), k_pred).to(assign.dtype)
        one_max = F.one_hot(max_i, k_pred).to(assign.dtype)
        assign = assign + do * (one_k - one_max)[:, :, None, :]
    return assign


def traj_aggr(trajs, scores, k_pred, thresh, n_iter_em, use_ade):
    """Greedy seeding (x0.1 suppression) then k-means EM over the modes; a
    cluster left empty after the split keeps its previous centroid."""
    n_pred = scores.shape[-1]
    within = _pairwise_dist(trajs[..., :2], use_ade) < float(thresh[0])
    sc = scores
    idxs = []
    for _ in range(k_pred):
        idx = sc.argmax(dim=-1)
        idxs.append(idx)
        sc = sc * torch.where(_row(within, idx), 0.1, 1.0)
        sc = sc - F.one_hot(idx, n_pred).to(sc.dtype)
    mode_idx = torch.stack(idxs, dim=-1)
    t_idx = mode_idx[:, :, :, None, None].expand(-1, -1, -1, *trajs.shape[3:])
    trajs_k = torch.gather(trajs, 2, t_idx)
    scores_k = torch.gather(scores, 2, mode_idx)

    xy = trajs[..., :2]
    for _ in range(n_iter_em):
        xy_k = trajs_k[..., :2]
        if use_ade:
            dist = torch.linalg.norm(xy_k[:, :, None] - xy[:, :, :, None], dim=-1).mean(dim=-1)  # [S, A, P, K]
        else:
            dist = torch.linalg.norm(xy_k[:, :, None, :, -1] - xy[:, :, :, None, -1], dim=-1)
        assign = F.one_hot(dist.argmin(dim=-1), k_pred).to(trajs.dtype)  # [S, A, P, K]
        assign = _split_largest_into_empty(assign, k_pred)
        n_members = assign.sum(dim=2)  # [S, A, K]
        safe = n_members.clamp(min=1.0)
        new_trajs_k = (trajs[:, :, :, None] * assign[:, :, :, :, None, None]).sum(dim=2) / safe[:, :, :, None, None]
        new_scores_k = (scores[:, :, :, None] * assign).sum(dim=2) / safe
        empty = n_members == 0
        trajs_k = torch.where(empty[..., None, None], trajs_k, new_trajs_k)
        scores_k = torch.where(empty, scores_k, new_scores_k)
    return trajs_k, scores_k / scores_k.sum(dim=-1, keepdim=True)


def mpa_nms(valid, trajs, scores, type_thresh, use_ade, agent_type):
    """Set a mode's score to 1e-3 when a strictly better mode lies within
    the threshold (order-independent: only the original scores are read)."""
    thresh = _type_thresh(agent_type, type_thresh)[:, :, None, None]
    within = _pairwise_dist(trajs[..., :2], use_ade) < thresh  # [S, A, K, K]
    better = scores[:, :, None, :] > scores[:, :, :, None]
    suppress = (within & better).any(dim=-1) & valid[:, :, None]
    scores = torch.where(suppress, torch.full_like(scores, 1e-3), scores)
    return scores / scores.sum(dim=-1, keepdim=True)


def waymo_post_processing(
    cfg: PostProcessingConfig,
    valid: Tensor,  # [S, A]
    scores: Tensor,  # [S, A, P] unnormalized
    trajs: Tensor,  # [S, A, P, T, 2..4]
    agent_type: Tensor,  # [S, A, 3]
) -> Dict[str, Optional[Tensor]]:
    scores = scores / scores.sum(dim=-1, keepdim=True)
    n_pred, n_step, d_traj = trajs.shape[2], trajs.shape[3], trajs.shape[-1]
    if n_pred > cfg.k_pred:
        if len(cfg.aggr_thresh) > 0:
            trajs, scores = traj_aggr(trajs, scores, cfg.k_pred, cfg.aggr_thresh, cfg.n_iter_em, cfg.use_ade)
        elif len(cfg.mtr_nms_thresh) > 0:
            trajs, scores = mtr_nms(trajs, scores, cfg.k_pred, cfg.mtr_nms_thresh, cfg.use_ade, agent_type)
        else:
            trajs, scores = traj_topk(trajs, scores, cfg.k_pred)
    if len(cfg.mpa_nms_thresh) > 0:
        scores = mpa_nms(valid, trajs, scores, cfg.mpa_nms_thresh, cfg.use_ade, agent_type)
    if cfg.score_temperature > 0:
        tiny = torch.finfo(scores.dtype).tiny
        scores = torch.softmax(torch.log(scores.clamp(min=tiny)) / cfg.score_temperature, dim=-1)
    trajs = torch.movedim(trajs, 3, 1)  # [S, T, A, K, d]
    return {
        "waymo_trajs": trajs[..., :2],
        "waymo_yaw_bbox": trajs[..., 2:3] if d_traj >= 3 else None,
        "waymo_spd": trajs[..., 3:4] if d_traj >= 4 else None,
        "waymo_scores": scores,
        "waymo_valid": valid[:, None].expand(valid.shape[0], n_step, valid.shape[1]),
    }
