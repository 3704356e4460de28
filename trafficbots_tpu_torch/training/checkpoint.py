"""Checkpoints: {params, opt_state, epoch, global_step, rng} with best/last.

Counterpart of `trafficbots_tpu/training/checkpoint.py`, with its API and
semantics: top-1 on the monitored score (`val/loss`, mode min) plus a
rolling `last`; `meta.json` (best score, step, metrics) in the manager's
directory; a `config.json` sidecar inside each checkpoint, so a checkpoint
copied out of its run stays self-describing; the `TB_CKPT_HOOK` hook after
each save, a failing hook warned about and disabled; `restore` selecting
the requested keys from a checkpoint that holds more (validate and test
read the params alone from a fit's full trainer state), failing on a
shape mismatch; `restore_trainer_state` reading a slim {params, opt_state}
checkpoint too.

The format is the port's own (it does not read orbax checkpoints): each
checkpoint is a directory holding one `torch.save` file, `state.pt`, and
`config.json`. The state is tensors, numbers and strings only, so it
loads under `torch.load(..., weights_only=True)`. The CLI saves the
model's `state_dict` as `params`, `Optimizer.state_dict()` as `opt_state`,
`epoch`, `global_step`, and the run's CPU `torch.Generator` state as `rng`
(the counterpart of the JAX package's PRNG key).

Data parallel: the state is replicated, so rank 0 alone writes each
checkpoint, its `config.json`, `meta.json` and calls the hook; every rank
then waits at a barrier, so no rank reads a checkpoint before it is
complete. The best-or-not decision reads the reduced `val/loss`, the same
on every rank, and every rank keeps `best_score`; every rank restores.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..parallel import mesh

STATE_FILE = "state.pt"


def _load_ckpt_hook():
    """Resolve the optional checkpoint-artifact hook from TB_CKPT_HOOK.

    Format "pkg.module:callable" (callable defaults to `on_checkpoint`). The
    callable receives (path, step, score, is_best) after every best/last
    save: point it at a wandb/GCS/S3 uploader without the framework
    depending on any of them. No-op when unset; failures are isolated like
    the metrics sink (utils/logging.py).
    """
    spec = os.environ.get("TB_CKPT_HOOK")
    if not spec:
        return None
    import importlib

    mod, _, fn = spec.partition(":")
    try:
        return getattr(importlib.import_module(mod), fn or "on_checkpoint")
    except Exception as e:  # a bad spec must not kill the run
        import warnings

        warnings.warn(f"TB_CKPT_HOOK={spec!r} failed to load ({e!r}); "
                      "checkpoints stay local-only")
        return None


def _check_compatible(name: str, target, stored, path: str = "") -> None:
    """Raise ValueError unless `stored` has `target`'s dict keys and leaf
    shapes (a checkpoint of another model config)."""
    if isinstance(target, dict):
        if not isinstance(stored, dict) or set(target) != set(stored):
            raise ValueError(f"checkpoint {name!r} is incompatible with the current model config: the keys "
                             f"at {path or 'the top'} differ")
        for k in target:
            _check_compatible(name, target[k], stored[k], f"{path}[{k!r}]")
        return
    ts, ss = getattr(target, "shape", None), getattr(stored, "shape", None)
    if ts is not None and ss is not None and tuple(ts) != tuple(ss):
        raise ValueError(
            f"checkpoint {name!r} is incompatible with the current model config: stored leaf shape "
            f"{tuple(ss)} != target {tuple(ts)} at {path}"
        )


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        monitor: str = "val/loss",
        mode: str = "min",
        config: Optional[Dict[str, Any]] = None,
        hook=None,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_score: Optional[float] = None
        # the config dict, snapshotted INSIDE each checkpoint directory
        self.config = config
        # `hook` (programmatic) wins over the TB_CKPT_HOOK env adapter
        self.hook = hook if hook is not None else _load_ckpt_hook()
        self._meta_path = os.path.join(self.directory, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.best_score = meta.get("best_score")

    def _save(self, name: str, state: Dict[str, Any]) -> str:
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))  # a reader never sees half a file
        if self.config is not None:
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(self.config, f, indent=2)
        return path

    def _fire_hook(self, path: str, step: int, metrics: Dict[str, float], is_best: bool):
        if self.hook is None:
            return
        try:
            self.hook(path, step, float(metrics.get(self.monitor, float("nan"))), is_best)
        except Exception as e:  # an uploader failure must not kill training
            import warnings

            warnings.warn(f"checkpoint hook failed ({e!r}); disabling it")
            self.hook = None

    def save_last(self, state: Dict[str, Any], step: int, metrics: Dict[str, float]):
        if mesh.is_main():
            path = self._save("last", state)
            self._write_meta(step=step, metrics=metrics)
            self._fire_hook(path, step, metrics, is_best=False)
        mesh.barrier()

    def save_if_best(self, state: Dict[str, Any], step: int, metrics: Dict[str, float]) -> bool:
        score = float(metrics[self.monitor])
        improved = (
            self.best_score is None
            or (self.mode == "min" and score < self.best_score)
            or (self.mode == "max" and score > self.best_score)
        )
        if improved:
            self.best_score = score
            if mesh.is_main():
                path = self._save("best", state)
                self._write_meta(step=step, metrics=metrics)
                self._fire_hook(path, step, metrics, is_best=True)
            mesh.barrier()
        return improved

    def _write_meta(self, step: int, metrics: Dict[str, float]):
        with open(self._meta_path, "w") as f:
            json.dump(
                {"best_score": self.best_score, "step": step,
                 "metrics": {k: float(v) for k, v in metrics.items()}},
                f, indent=2,
            )

    def _path(self, name: str) -> str:
        """`name` is either a managed checkpoint name (best/last) or an
        explicit path to a checkpoint directory."""
        if name not in ("best", "last") and os.path.isdir(name):
            return os.path.abspath(name)
        return os.path.join(self.directory, name)

    def load(self, name: str, map_location="cpu") -> Dict[str, Any]:
        """The whole stored state, tensors on `map_location`."""
        return torch.load(os.path.join(self._path(name), STATE_FILE), map_location=map_location,
                          weights_only=True)

    def restore(self, name: str, target: Dict[str, Any], map_location="cpu") -> Dict[str, Any]:
        """Restore `target`'s keys, tolerating checkpoints that carry MORE
        state than requested (a fit's `last`, restored params-only by
        validate/test). The selected entries must match the target's keys
        and leaf shapes, so a checkpoint of another model config fails here
        with a clear error instead of deep inside the model."""
        full = self.load(name, map_location)
        missing = [k for k in target if k not in full]
        if missing:
            raise ValueError(f"checkpoint {name!r} holds no {missing}")
        out = {k: full[k] for k in target}
        _check_compatible(name, target, out)
        return out

    def restore_trainer_state(self, name: str, target: Dict[str, Any], map_location="cpu") -> Dict[str, Any]:
        """Restore a full trainer state, tolerating checkpoints written
        without epoch/global_step/rng: those restore {params, opt_state}
        only and keep the target's counters (resume at epoch 0)."""
        full = self.load(name, map_location)
        keys = list(target) if all(k in full for k in target) else ["params", "opt_state"]
        out = dict(target)
        out.update({k: full[k] for k in keys})
        _check_compatible(name, target["params"], out["params"], "['params']")
        return out

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._path(name), STATE_FILE))
