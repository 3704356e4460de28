"""Weights: loading the JAX package's flax parameters, and the port's own seeded init.

`load_jax_params(model, params_np)` takes the flax param tree as nested
dicts of numpy arrays (`jax.tree_util.tree_map(np.asarray, params)`, made on
the caller's side: this module never imports JAX). The port's module tree
mirrors the flax tree by name, so the walk is mechanical:

  - an `nn.Linear` at path p reads p/kernel [in, out] transposed into
    `weight` [out, in] and p/bias;
  - an `nn.LayerNorm` reads p/scale into `weight` and p/bias;
  - any other parameter (the stacked node-encoder arrays, the fused GRU
    cell's w_i/w_h/b_i/b_hn, the action head's stacked branches, log_std)
    is copied as it is from the leaf of the same name.

It is strict: a port parameter without its flax array raises, and so does a
flax array nothing consumed, unless it lies under one of the subtrees named
in `SKIPPED_SUBTREES` (parts of the model outside the ported slice).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

# flax subtrees with no counterpart in the port yet: the destination / goal
# predictor heads (DestPredictor, GoalPredictor) come with the validation slice
SKIPPED_SUBTREES = ("goal_manager",)


def _flat(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _assign(param: torch.Tensor, value: np.ndarray, name: str) -> None:
    t = torch.tensor(np.array(value), dtype=param.dtype)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: flax shape {tuple(t.shape)} != port shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t.to(param.device))


def load_jax_params(model: nn.Module, params_np: Dict, skip: Iterable[str] = SKIPPED_SUBTREES) -> None:
    """Fill every parameter of `model` from the flax tree `params_np`."""
    flat = _flat(params_np)
    used = set()

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"no flax array for port parameter at {path}")
        used.add(path)
        return flat[path]

    for mod_name, mod in model.named_modules():
        base = mod_name.replace(".", "/")
        pre = f"{base}/" if base else ""
        if isinstance(mod, nn.Linear):
            _assign(mod.weight, take(pre + "kernel").T, pre + "kernel")
            if mod.bias is not None:
                _assign(mod.bias, take(pre + "bias"), pre + "bias")
        elif isinstance(mod, nn.LayerNorm):
            _assign(mod.weight, take(pre + "scale"), pre + "scale")
            _assign(mod.bias, take(pre + "bias"), pre + "bias")
        else:
            for pname, p in mod.named_parameters(recurse=False):
                _assign(p, take(pre + pname), pre + pname)

    skipped = tuple(s.rstrip("/") + "/" for s in skip)
    left = sorted(k for k in flat if k not in used and not k.startswith(skipped))
    if left:
        raise ValueError(f"flax arrays not consumed by the port: {left}")


def init_params(model: nn.Module, seed: int) -> None:
    """The port's own seeded initialization (CPU generator, so a seed gives
    the same weights on any device): Linear weights and the raw weight
    matrices ~ N(0, 1/fan_in) (LeCun normal, fan_in the input width), biases
    0, LayerNorm scale 1 / shift 0, the node encoder's LN scales 1; log_std
    keeps its configured constant."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, fan_in: int) -> None:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))

    for _, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            normal_(mod.weight, mod.in_features)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        else:
            for pname, p in mod.named_parameters(recurse=False):
                if pname == "log_std":
                    continue
                if pname.endswith("_s"):  # stacked LayerNorm scales
                    nn.init.ones_(p)
                elif pname.startswith("w") or "_w" in pname:
                    normal_(p, p.shape[-2])  # [.., in, out] JAX layout
                else:
                    nn.init.zeros_(p)
