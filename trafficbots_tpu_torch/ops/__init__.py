"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper decides by device alone: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version. Which of the two a model CALL
SITE asks for is decided here: the call sites (`models.modules.Attention`
and the dropout sites of `models.modules`, `models.map_encoder.MapEncoder`)
call the wrapper while `kernels_enabled()` is True, and the plain version
directly inside `plain_versions()`, so the same path can be run on the card
with and without the kernels (chip_smoke.py compares the two end to end).
"""
from __future__ import annotations

import contextlib

import torch

_ENABLED = True


def round_to(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x rounded to `dtype` (to nearest even), held in fp32: a bf16 operand
    of the plain versions' products."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def kernels_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def plain_versions():
    """Run the block with every call site on the plain versions."""
    global _ENABLED
    saved, _ENABLED = _ENABLED, False
    try:
        yield
    finally:
        _ENABLED = saved
