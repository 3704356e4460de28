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

Data parallel (a process group of more than one rank, JAX's
`make_jitted_dp_train_step`): each rank steps on its slice of the
global batch with its own draws (`mesh.rank_seed`), then the gradients are
averaged over the ranks in one all-reduce, the loss averaged and every
other metric summed; the guard, the clip and Adam follow on the reduced
gradients, so the parameters and Adam's state stay replicated.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import orchestration as O
from ..config import ExperimentConfig
from ..data.preprocessing import to_torch
from ..parallel import mesh

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

    def state_dict(self) -> Dict[str, Dict]:
        """Adam's state (moments and step counts) and the schedule's step
        count: what a resumed run needs to continue where this one stopped."""
        return {"adam": self.adam.state_dict(), "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: Dict[str, Dict]) -> None:
        self.adam.load_state_dict(state["adam"])
        # Adam keeps its step counts on the CPU (they are read on the host);
        # a checkpoint mapped onto the card would leave them there
        for s in self.adam.state.values():
            if isinstance(s.get("step"), Tensor):
                s["step"] = s["step"].cpu()
        self.schedule.load_state_dict(state["schedule"])


def make_optimizer(cfg: ExperimentConfig, model: torch.nn.Module, steps_per_epoch: int = 1000) -> Optimizer:
    return Optimizer(cfg, model, steps_per_epoch)


def make_train_step(cfg: ExperimentConfig, model: torch.nn.Module, optimizer: Optimizer,
                    guard: Optional[Callable[[Dict], object]] = None) -> Callable:
    """-> step(batch, seed, epoch=0) -> metrics: one training step on a numpy
    episode batch (the data.synthetic contract) on the model's device. All
    of the step's random draws come from a CPU generator seeded by `seed`
    (by `mesh.rank_seed(seed)` in a process group of more than one rank:
    `batch` is then the rank's slice of the global batch). `guard`, when given, sees
    {"metrics": ..., "grads": ...} after the backward (and the reduction
    over the ranks) and before the update (the CLI's `debug_nans` check):
    a non-finite value on one rank reaches every rank, so all raise."""
    device = next(model.parameters()).device
    params = list(model.parameters())

    def step(batch: Dict[str, np.ndarray], seed: int, epoch: int = 0) -> Dict[str, Tensor]:
        world = mesh.world_size()
        generator = torch.Generator().manual_seed(mesh.rank_seed(seed))
        optimizer.adam.zero_grad(set_to_none=True)
        loss, metrics = O.training_step(cfg, model, to_torch(batch, device), generator, current_epoch=epoch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if world > 1:
            mesh.all_reduce_mean_(params)
            metrics = mesh.all_reduce_sum(metrics)
            metrics["loss"] = metrics["loss"] / world
        if guard is not None:
            guard({"metrics": metrics, "grads": {n: p.grad for n, p in model.named_parameters()}})
        metrics.update(optimizer.step())
        return metrics

    return step
