"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper decides by device alone: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version. Which of the two a model CALL
SITE asks for is decided here: the call sites (`models.modules.Attention`,
`models.map_encoder.MapEncoder`) call the wrapper while `kernels_enabled()`
is True, and the plain version directly inside `plain_versions()`, so the
same path can be run on the card with and without the kernels (chip_smoke.py
compares the two end to end).
"""
from __future__ import annotations

import contextlib

_ENABLED = True


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
