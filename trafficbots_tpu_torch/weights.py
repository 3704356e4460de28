"""Weights: loading the JAX package's flax parameters, and the port's own seeded init.

`load_jax_params(model, params_np)` takes the flax param tree as nested
dicts of numpy arrays (`jax.tree_util.tree_map(np.asarray, params)`, made on
the caller's side: this module never imports JAX). The port's module tree
mirrors the flax tree by name, so the walk is mechanical (`flax_paths`):

  - an `nn.Linear` at path p reads p/kernel [in, out] transposed into
    `weight` [out, in] and p/bias;
  - an `nn.LayerNorm` reads p/scale into `weight` and p/bias;
  - any other parameter (the stacked node-encoder arrays, the fused GRU
    cell's w_i/w_h/b_i/b_hn, the action head's stacked branches, log_std)
    is copied as it is from the leaf of the same name.

It is strict: a port parameter without its flax array raises, and so does a
flax array nothing consumed. `flax_paths` is also the reverse map the tests
use to compare gradients leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def _flat(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """Port parameter name -> (flax leaf path, whether the flax array is
    the transpose of the port's: the `nn.Linear` kernels)."""
    out = {}
    for mod_name, mod in model.named_modules():
        base = mod_name.replace(".", "/")
        pre = f"{base}/" if base else ""
        dot = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Linear):
            out[dot + "weight"] = (pre + "kernel", True)
            if mod.bias is not None:
                out[dot + "bias"] = (pre + "bias", False)
        elif isinstance(mod, nn.LayerNorm):
            out[dot + "weight"] = (pre + "scale", False)
            out[dot + "bias"] = (pre + "bias", False)
        else:
            for pname, _ in mod.named_parameters(recurse=False):
                out[dot + pname] = (pre + pname, False)
    return out


def load_jax_params(model: nn.Module, params_np: Dict) -> None:
    """Fill every parameter of `model` from the flax tree `params_np`."""
    flat = _flat(params_np)
    params = dict(model.named_parameters())
    paths = flax_paths(model)
    for name, (path, transposed) in paths.items():
        if path not in flat:
            raise KeyError(f"no flax array for port parameter at {path}")
        value = flat[path].T if transposed else flat[path]
        param = params[name]
        t = torch.tensor(np.array(value), dtype=param.dtype)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{path}: flax shape {tuple(t.shape)} != port shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(param.device))
    left = sorted(set(flat) - {path for path, _ in paths.values()})
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
