"""Training loss: balanced KL + differentiable reward + goal NLL.

Counterpart of `trafficbots_tpu/training/loss.py`: one function maps a
rollout to (loss, metrics), the metrics as (sum, count) pairs, with every
masking rule of the JAX function (irrelevant agents, teacher-forced steps,
the warm-up steps before `step_training_start`, unseen agents, relevance
weights).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import TrainingMetricsConfig
from ..distributions import DiagGaussian, DummyLatent, MultiCategorical, kl_diag_gaussian, kl_multi_categorical

Tensor = torch.Tensor


def _kl(post, prior) -> Tensor:
    if isinstance(post, MultiCategorical):
        return kl_multi_categorical(post, prior)
    return kl_diag_gaussian(post, prior)


def _kl_detached(post, prior, detach_post: bool) -> Tensor:
    if isinstance(post, MultiCategorical):
        if detach_post:
            return kl_multi_categorical(MultiCategorical(post.probs.detach()), prior)
        return kl_multi_categorical(post, MultiCategorical(prior.probs.detach()))
    if detach_post:
        return kl_diag_gaussian(DiagGaussian(post.mean.detach(), post.log_std.detach()), prior)
    return kl_diag_gaussian(post, DiagGaussian(prior.mean.detach(), prior.log_std.detach()))


def balanced_kl(post, prior, alpha: float, free_nats: float) -> Tensor:
    """Dreamer-style two-sided KL with free nats over two DiagGaussians or
    two MultiCategoricals: alpha > 0 trains the prior with weight alpha and
    the posterior with 1 - alpha."""
    if alpha > 0:
        e0 = _kl_detached(post, prior, detach_post=True)
        e1 = _kl_detached(post, prior, detach_post=False)
        if free_nats > 0:
            e0 = torch.clamp(e0, min=free_nats)
            e1 = torch.clamp(e1, min=free_nats)
        return alpha * e0 + (1.0 - alpha) * e1
    err = _kl(post, prior)
    if free_nats > 0:
        err = torch.clamp(err, min=free_nats)
    return err


def training_loss(
    cfg: TrainingMetricsConfig,
    pred_valid: Tensor,  # [B, A, S]
    diffbar_rewards_valid: Tensor,  # [B, A, S]
    diffbar_rewards: Tensor,  # [B, A, S]
    override_masks: Tensor,  # [B, A, S]
    agent_role: Tensor,  # [B, A, 3]
    goal_valid: Optional[Tensor],
    goal_pred,  # DestCategorical | DiagGaussian (goal_xy) | None
    goal_gt: Optional[Tensor],
    latent_post,
    latent_prior,
    step_start: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """-> (scalar loss, metrics of sums and counts). `generator` draws the
    irrelevant agents kept under `p_loss_for_irrelevant > 0`."""
    metrics: Dict[str, Tensor] = {}
    pv = pred_valid
    if cfg.p_loss_for_irrelevant > 0:
        if generator is None:
            raise ValueError("p_loss_for_irrelevant > 0 needs a generator")
        mask_rel = agent_role.any(dim=-1)[..., None]
        u = torch.rand(mask_rel.shape, generator=generator, device=generator.device).to(pv.device)
        pv = (pv & mask_rel) | (u < cfg.p_loss_for_irrelevant)
    if not cfg.loss_for_teacher_forcing:
        pv = pv & ~override_masks
    if cfg.step_training_start > 0:
        n_skip = max(0, cfg.step_training_start - step_start + 1)
        step_idx = torch.arange(pv.shape[-1], device=pv.device)
        pv = pv & (step_idx >= n_skip)[None, None, :]

    w_rel = None
    if cfg.w_relevant_agent > 0:
        w_rel = (pv.any(dim=-1).float() + agent_role.any(dim=-1).float() * cfg.w_relevant_agent).detach()

    loss = torch.zeros((), device=pv.device)
    seen = pv.any(dim=-1)

    if cfg.w_vae_kl > 0 and latent_post is not None and not isinstance(latent_post, DummyLatent):
        kl_valid = (latent_post.valid if cfg.kl_for_unseen_agent else latent_prior.valid) & seen
        err = balanced_kl(latent_post, latent_prior, cfg.kl_balance_scale, cfg.kl_free_nats)
        if w_rel is not None:
            err = err * w_rel
        kl_sum = torch.where(kl_valid, err, torch.zeros_like(err)).sum()
        kl_count = kl_valid.sum().float()
        metrics["vae_kl_sum"], metrics["vae_kl_count"] = kl_sum, kl_count
        loss = loss + cfg.w_vae_kl * kl_sum / kl_count.clamp(min=1.0)

    if cfg.w_diffbar_reward > 0:
        rv = pv & diffbar_rewards_valid
        err = torch.where(rv, diffbar_rewards, torch.zeros_like(diffbar_rewards))
        if w_rel is not None:
            err = err * w_rel[..., None]
        r_sum = -err.sum()
        r_count = rv.sum().float()
        metrics["diffbar_reward_sum"], metrics["diffbar_reward_count"] = r_sum, r_count
        loss = loss + cfg.w_diffbar_reward * r_sum / r_count.clamp(min=1.0)

    if cfg.w_goal > 0 and goal_pred is not None:
        gv = goal_pred.valid & seen
        nll = -goal_pred.log_prob(goal_gt)
        nll = torch.where(gv, nll, torch.zeros_like(nll))
        if w_rel is not None:
            nll = nll * w_rel
        g_sum = nll.sum()
        g_count = gv.sum().float()
        metrics["goal_loss_sum"], metrics["goal_loss_count"] = g_sum, g_count
        loss = loss + cfg.w_goal * g_sum / g_count.clamp(min=1.0)

    metrics["loss"] = loss
    return loss, metrics
