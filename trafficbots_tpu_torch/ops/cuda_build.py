"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `trafficbots_tpu_torch/build/lib<name>-<hash>.so`
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`),
where <hash> covers the source text, the shared `csrc/*.cuh` headers and
the flags, so an edited source is rebuilt and an unchanged one is reused.
A source may be built more than once with `-D` defines (the node kernels'
widths, `ops.node_encoder.build_defines`): a kernel is named by
`(name, defines)` then, each build its own library. Nothing here runs at import time:
the wrappers call `load(name)` when a CUDA tensor reaches them, and a
machine without nvcc never gets that far.

`build_all(names)` starts one nvcc per source (or `(name, defines)`
build) at once and waits for all, so a cold start pays for the slowest
kernel rather than the sum. `entry(name, symbol, argtypes, defines)` binds
a C entry once; `stream(t)` is the raw handle of the stream a wrapper
launches on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple, Union

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

Build = Union[str, Tuple[str, Tuple[str, ...]]]  # a source's name, or (name, its -D defines)

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, Tuple[str, ...], str], Callable[..., int]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _split(build: Build) -> Tuple[str, Tuple[str, ...]]:
    return (build, ()) if isinstance(build, str) else (build[0], tuple(build[1]))


def label(build: Build) -> str:
    """A build's name: the source's, with its defines after it."""
    name, defines = _split(build)
    return " ".join((name, *defines))


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    # the hash covers the shared headers too (philox.cuh), so editing one
    # rebuilds every kernel that may include it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join((*NVCC_FLAGS, *defines)).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def _command(name: str, out: Path, defines: Sequence[str] = ()):
    return [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[Build]) -> Dict[str, float]:
    """Compile every listed kernel (a source's name, or (name, defines))
    that is not built yet, all in parallel. Returns each build's seconds by
    its `label` (0.0 when it was already built)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    builds = [_split(b) for b in names]
    procs = {}
    t0 = time.perf_counter()
    for name, defines in builds:
        out = _target(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[label((name, defines))] = (subprocess.Popen(_command(name, tmp, defines), stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    secs = {label(b): 0.0 for b in builds}
    errors = []
    for what, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[what] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {what} (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu built with `defines`, built
    first if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        out = _target(name, defines)
        if not out.exists():
            build_all([key])
        lib = ctypes.CDLL(str(out))
        _LIBS[key] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence, defines: Sequence[str] = ()) -> Callable[..., int]:
    """The C entry `symbol` of csrc/<name>.cu (built with `defines`) with
    its prototype set, bound once and cached: setting a ctypes prototype on
    every call costs the host more than a small kernel takes on the card."""
    key = (name, tuple(defines), symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(load(name, defines), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (where a kernel
    launches), without building a torch.cuda.Stream object. The C entries
    launch on the current device, so t must live there: a rank's tensors on
    another card raise instead of launching into the wrong one."""
    dev = t.get_device()
    if dev != torch.cuda.current_device():
        raise RuntimeError(f"a tensor on cuda:{dev} while the current device is cuda:{torch.cuda.current_device()}: "
                           "call torch.cuda.set_device first")
    return torch._C._cuda_getCurrentRawStream(dev)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
