"""Start n ranks of a function with the `torchrun` environment, and audit
the files a rank writes.

    outputs, results = launch("pkg.module:function", n, {"arg": 1}, timeout_s=300)

runs `function(**kwargs)` in n processes started by
`torch.multiprocessing.start_processes` (spawn: the module must be
importable from the caller's `sys.path`), each with `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` set as
`torchrun --standalone` sets them (one host, a free local port) and one
torch thread; the function joins the group with `mesh.init_from_env`.
Returns each rank's standard output and error (one string a rank) and its
return value. A rank that fails, or a run past `timeout_s`, stops every
rank and raises with the tails of their outputs: no rank is left waiting in
a collective.
"""
from __future__ import annotations

import builtins
import contextlib
import importlib
import os
import socket
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(r: int, target: str, kwargs: Dict[str, Any], n: int, port: int, tmp: str) -> None:
    import torch

    log = open(os.path.join(tmp, f"rank{r}.log"), "w")
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    os.environ.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    module, _, name = target.partition(":")
    result = getattr(importlib.import_module(module), name)(**kwargs)
    torch.save(result, os.path.join(tmp, f"rank{r}.pt"))
    sys.stdout.flush()
    sys.stderr.flush()


def launch(target: str, n: int, kwargs: Optional[Dict[str, Any]] = None,
           timeout_s: float = 600.0) -> Tuple[List[str], List[Any]]:
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="tb_ranks_") as tmp:
        ctx = mp.start_processes(_rank, args=(target, kwargs or {}, n, free_port(), tmp), nprocs=n, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while not ctx.join(timeout=1.0, grace_period=5.0):
                if time.monotonic() > deadline:
                    failure = f"timed out after {timeout_s} s"
                    break
        except Exception as e:  # a rank raised or died; join stopped the others
            failure = str(e)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        outs = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.log")
            outs.append(open(path, errors="replace").read() if os.path.exists(path) else "")
        if failure is not None:
            tails = "\n".join(f"--- rank {r} ---\n{out[-4000:]}" for r, out in enumerate(outs))
            raise RuntimeError(f"{target} on {n} ranks: {failure}\n{tails}")
        return outs, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


@contextlib.contextmanager
def audit_writes(root):
    """Within the block, record every file this process opens for writing
    under `root` (open, torch.save, os.replace), relative to `root`, in the
    list it yields: the host artifacts a rank wrote. The three functions
    are restored on leaving."""
    import torch

    root = os.path.abspath(root)
    written: List[str] = []
    real_open, real_save, real_replace = builtins.open, torch.save, os.replace

    def note(f):
        if isinstance(f, (str, os.PathLike)) and os.path.abspath(f).startswith(root):
            written.append(os.path.relpath(os.path.abspath(f), root))

    def audited_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *a, **kw)

    def audited_save(obj, f, *a, **kw):
        note(f)
        return real_save(obj, f, *a, **kw)

    def audited_replace(src, dst, *a, **kw):
        note(dst)
        return real_replace(src, dst, *a, **kw)

    builtins.open, torch.save, os.replace = audited_open, audited_save, audited_replace
    try:
        yield written
    finally:
        builtins.open, torch.save, os.replace = real_open, real_save, real_replace
