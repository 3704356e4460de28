"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `trafficbots_tpu_torch/build/lib<name>-<hash>.so`
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`),
where <hash> covers the source text, the shared `csrc/*.cuh` headers and
the flags, so an edited source is rebuilt and an unchanged one is reused. Nothing here runs at import time:
the wrappers call `load(name)` when a CUDA tensor reaches them, and a
machine without nvcc never gets that far.

`build_all(names)` starts one nvcc per source at once and waits for all,
so a cold start pays for the slowest kernel rather than the sum.
`entry(name, symbol, argtypes)` binds a C entry once; `stream(t)` is the
raw handle of the stream a wrapper launches on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    # the hash covers the shared headers too (philox.cuh), so editing one
    # rebuilds every kernel that may include it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def _command(name: str, out: Path):
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every listed kernel that is not built yet, all in parallel.
    Returns each kernel's build seconds (0.0 when it was already built)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry `symbol` of csrc/<name>.cu with its prototype set, bound
    once and cached: setting a ctypes prototype on every call costs the host
    more than a small kernel takes on the card."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (where a kernel
    launches), without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
