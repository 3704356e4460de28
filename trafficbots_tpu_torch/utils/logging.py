"""Local experiment logging: JSONL metrics stream + profiling hooks.

Counterpart of `trafficbots_tpu/utils/logging.py`. Metrics append to
`metrics.jsonl` per run, one record a call (`step`, `phase`, `time`, then
the float metrics), with the optional `TB_METRICS_HOOK` sink; `Profiler`
times named phases on the wall clock (`summary()` gives
`time/<phase>_mean_s`) and, given a `trace_dir`, records device traces with
`torch.profiler` as Chrome traces; `nan_guard` fails fast on non-finite
values in a nested structure of tensors and arrays (the CLI's
`debug_nans=true`). Under data parallelism `MetricsLogger` writes (and
calls its sink) on rank 0 only; the `Profiler` times each rank's own
phases.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple


def _load_metrics_hook():
    """Resolve the optional external metrics sink from TB_METRICS_HOOK.

    Format "pkg.module:callable" (callable defaults to `log_metrics`). The
    callable receives each record dict (step/phase/time + float metrics):
    point it at a wandb/TensorBoard/DB adapter without the framework
    depending on any of them. No-op when unset.
    """
    spec = os.environ.get("TB_METRICS_HOOK")
    if not spec:
        return None
    import importlib

    mod, _, fn = spec.partition(":")
    try:
        return getattr(importlib.import_module(mod), fn or "log_metrics")
    except Exception as e:  # a bad spec must not kill the run
        import warnings

        warnings.warn(f"TB_METRICS_HOOK={spec!r} failed to load ({e!r}); "
                      "metrics go to metrics.jsonl only")
        return None


class MetricsLogger:
    def __init__(self, run_dir: str, sink=None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, "metrics.jsonl")
        # `sink` (programmatic) wins over the TB_METRICS_HOOK env adapter
        self.sink = sink if sink is not None else _load_metrics_hook()

    def log(self, metrics: Dict[str, Any], step: int, phase: str = "train"):
        from ..parallel.mesh import is_main

        if not is_main():
            return
        rec = {"step": step, "phase": phase, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):  # RuntimeError: a tensor of more than one element
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.sink is not None:
            try:
                self.sink(rec)
            except Exception as e:  # a sink failure must not kill training
                import warnings

                warnings.warn(f"metrics sink failed ({e!r}); disabling it")
                self.sink = None


class Profiler:
    """Phase timing + optional torch.profiler device traces."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def device_trace(self, name: str = "trace"):
        """Record the block under torch.profiler (the host, and the card when
        CUDA is available) into `<trace_dir>/<name>/trace.json`, a Chrome
        trace; a no-op without a trace_dir."""
        if self.trace_dir is None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        path = os.path.join(self.trace_dir, name)
        os.makedirs(path, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(path, "trace.json"))

    def summary(self) -> Dict[str, float]:
        return {
            f"time/{k}_mean_s": self.times[k] / max(self.counts[k], 1) for k in self.times
        }


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs of nested dicts, lists and tuples, the key
    paths written as jax.tree_util.keystr writes them (['a'][0])."""
    if isinstance(tree, dict):
        for k in sorted(tree):  # jax.tree_util flattens a dict in key order
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def nan_guard(tree, name: str = "tree") -> bool:
    """Raise FloatingPointError naming the first five floating leaves of
    `tree` (tensors, arrays or numbers) that hold a NaN or an infinity."""
    import numpy as np
    import torch

    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
    return True
