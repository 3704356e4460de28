"""Optimizer, LR schedule and the training step: loss, BPTT backward, clip, Adam.

Counterpart of `trafficbots_tpu/training/train.py` (`make_optimizer`,
`make_train_step`): Adam with a separate LR group for the goal predictor
(`goal_manager.predictor.*`, lr_goal), StepLR by epoch as a per-step LR
lambda (the optimizer's step count over `steps_per_epoch`), and a clip by
global norm written as optax's `clip_by_global_norm`: g * max / norm when
norm > max (not `torch.nn.utils.clip_grad_norm_`, which divides by norm +
1e-6). The step returns the training metrics with `grad_norm` (before the
clip) and `grad_norm/<top-level module>`, as device tensors: reading them is
the caller's sync.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .. import orchestration as O
from ..config import ExperimentConfig
from ..data.preprocessing import to_torch

Tensor = torch.Tensor


def is_goal_predictor(name: str) -> bool:
    """The JAX split: the goal/destination predictor's parameters."""
    parts = name.split(".")
    return "goal_manager" in parts and "predictor" in parts


def lr_factor(cfg: ExperimentConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR(gamma, step_size epochs) of the optimizer's step count."""
    oc = cfg.optimizer

    def factor(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return oc.scheduler_gamma ** (epoch // oc.scheduler_step_size)

    return factor


class Optimizer:
    """Adam over the model's two LR groups with the StepLR schedule."""

    def __init__(self, cfg: ExperimentConfig, model: torch.nn.Module, steps_per_epoch: int = 1000):
        named = list(model.named_parameters())
        self.params = dict(named)
        goal = [p for n, p in named if is_goal_predictor(n)]
        main = [p for n, p in named if not is_goal_predictor(n)]
        groups = [{"params": main, "lr": cfg.optimizer.lr}]
        if goal:
            groups.append({"params": goal, "lr": cfg.optimizer.lr_goal})
        self.adam = torch.optim.Adam(groups)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adam, lr_factor(cfg, steps_per_epoch))
        self.clip = cfg.optimizer.gradient_clip_val

    def step(self) -> Dict[str, Tensor]:
        """Clip the gradients by their global norm, take one Adam step,
        advance the schedule; returns the grad-norm metrics."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.params.items()}
        sq = {n: g.square().sum() for n, g in grads.items()}
        norm = torch.stack(list(sq.values())).sum().sqrt()
        metrics = {"grad_norm": norm}
        for top in dict.fromkeys(n.split(".")[0] for n in grads):
            metrics[f"grad_norm/{top}"] = torch.stack([v for n, v in sq.items() if n.split(".")[0] == top]).sum().sqrt()
        for n, p in self.params.items():
            p.grad = torch.where(norm < self.clip, grads[n], grads[n] / norm * self.clip)
        self.adam.step()
        self.schedule.step()
        return metrics


def make_optimizer(cfg: ExperimentConfig, model: torch.nn.Module, steps_per_epoch: int = 1000) -> Optimizer:
    return Optimizer(cfg, model, steps_per_epoch)


def make_train_step(cfg: ExperimentConfig, model: torch.nn.Module, optimizer: Optimizer) -> Callable:
    """-> step(batch, seed, epoch=0) -> metrics: one training step on a numpy
    episode batch (the data.synthetic contract) on the model's device. All
    of the step's random draws come from a CPU generator seeded by `seed`."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, np.ndarray], seed: int, epoch: int = 0) -> Dict[str, Tensor]:
        generator = torch.Generator().manual_seed(seed)
        optimizer.adam.zero_grad(set_to_none=True)
        loss, metrics = O.training_step(cfg, model, to_torch(batch, device), generator, current_epoch=epoch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(optimizer.step())
        return metrics

    return step
