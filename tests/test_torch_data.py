"""The port's copies of the data modules and the native metric engine, held to the JAX package's.

- Each copied module's code equals the original's: the modules are parsed
  with `ast` and compared with their docstrings removed (comments never
  reach the tree; the copies' docstrings say where they came from). The
  native engine's C++ source equals the original apart from comment lines,
  and `NativeMotionMetrics` equals the JAX class.
- The same tiny packed h5 files (written by the port's `packing.write_h5`
  from `synthetic_scenario`) go through the port's `make_loaders` and the
  JAX package's: identical batches (keys, dtypes, values) under two shuffle
  seeds, `limit_train_batches`, a 2-way shard and `bucket_slice`.
- `womd_adapter` gives the JAX adapter's scenario on the duck-typed proto
  stub of tests/test_womd_adapter.py.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from trafficbots_tpu import config as jcfg  # noqa: E402
from trafficbots_tpu.data import bucketing as j_bucketing  # noqa: E402
from trafficbots_tpu.data import h5_loader as j_h5  # noqa: E402
from trafficbots_tpu.data import packing as j_packing  # noqa: E402
from trafficbots_tpu.data import synthetic_scenario as j_scenario  # noqa: E402
from trafficbots_tpu.data import womd_adapter as j_adapter  # noqa: E402
from trafficbots_tpu_torch import config as tcfg  # noqa: E402
from trafficbots_tpu_torch.data import bucketing as t_bucketing  # noqa: E402
from trafficbots_tpu_torch.data import h5_loader as t_h5  # noqa: E402
from trafficbots_tpu_torch.data import packing as t_packing  # noqa: E402
from trafficbots_tpu_torch.data import synthetic_scenario as t_scenario  # noqa: E402
from trafficbots_tpu_torch.data import womd_adapter as t_adapter  # noqa: E402

from test_womd_adapter import _stub_scenario  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["data/synthetic_scenario.py", "data/packing.py", "data/womd_adapter.py", "data/bucketing.py",
          "data/h5_loader.py"]
SMALL = dict(n_pl=64, n_tl=20, n_tl_stop=20, n_agent=8, n_agent_no_sim=16)


def code_of(tree: ast.AST) -> str:
    """ast.dump of the tree without its docstrings."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def parsed(package: str, rel: str) -> ast.Module:
    return ast.parse((ROOT / package / rel).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_code_equals_the_original(rel):
    assert code_of(parsed("trafficbots_tpu_torch", rel)) == code_of(parsed("trafficbots_tpu", rel))


def test_native_source_equals_the_original_apart_from_comment_lines():
    ours = (ROOT / "trafficbots_tpu_torch/native/motion_metrics.cc").read_text().splitlines()
    theirs = (ROOT / "native/motion_metrics.cc").read_text().splitlines()
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a != b:
            assert a.lstrip().startswith("//") and b.lstrip().startswith("//"), f"line {i + 1}: {a!r} != {b!r}"


def test_native_engine_class_equals_the_original():
    def cls(package):
        tree = parsed(package, "eval/native_metrics.py")
        return next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "NativeMotionMetrics")

    assert code_of(cls("trafficbots_tpu_torch")) == code_of(cls("trafficbots_tpu"))


def test_native_engine_builds_into_the_port_build_directory():
    from trafficbots_tpu_torch.eval import native_metrics as N

    N.load_library()
    path = N.library_path()
    assert path.is_file() and path.parent == ROOT / "trafficbots_tpu_torch" / "build"


def _episodes(packing, scenario, split, n):
    return [packing.pack_scenario(scenario.synthetic_scenario(seed=s), split, seed=s, **SMALL) for s in range(n)]


@pytest.fixture(scope="module")
def h5_dir(tmp_path_factory):
    """Packed training (7 episodes), validation (5) and testing (3) files,
    written by the port's packing from the port's synthetic scenarios; the
    JAX package's packing gives the same episodes."""
    d = tmp_path_factory.mktemp("h5")
    for split, n in (("training", 7), ("validation", 5), ("testing", 3)):
        eps = _episodes(t_packing, t_scenario, split, n)
        for (te, ta), (je, ja) in zip(eps, _episodes(j_packing, j_scenario, split, n)):
            assert te.keys() == je.keys() and ta.keys() == ja.keys()
            for k in te:
                np.testing.assert_array_equal(te[k], je[k], err_msg=k)
        assert t_packing.write_h5(eps, str(d / f"{split}.h5")) == n
    return str(d)


def _batches(loader_set, epoch):
    train, val, test = loader_set
    train.set_epoch(epoch)
    return {"train": list(train), "val": list(val), "test": list(test)}


def assert_batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], list):
                assert x[k] == y[k], k
            else:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("seed,limit,shard", [(0, 1.0, (0, 1)), (7, 2, (0, 1)), (3, 1.0, (1, 2))],
                         ids=["seed0-full", "seed7-limit2", "seed3-shard1of2"])
def test_make_loaders_yield_the_jax_batches(h5_dir, seed, limit, shard):
    kw = dict(SMALL, batch_size=2, data_dir=h5_dir)
    sets = [
        mod.make_loaders(cfg.DataConfig(**kw), seed, limit_train_batches=limit, shard_index=shard[0],
                         shard_count=shard[1])
        for mod, cfg in ((t_h5, tcfg), (j_h5, jcfg))
    ]
    for epoch in (0, 1):
        ours, theirs = (_batches(s, epoch) for s in sets)
        for split in ("train", "val", "test"):
            assert_batches_equal(ours[split], theirs[split])
        if shard[1] > 1:
            assert all(b["pad_mask"] is not None for b in ours["val"])
    # bucket_slice on the loaders' batches
    for x in _batches(sets[0], 0)["val"]:
        sx, bx = t_bucketing.bucket_slice(x, 16, 4)
        sy, by = j_bucketing.bucket_slice(x, 16, 4)
        assert bx == by and bx["n_pl"] < SMALL["n_pl"]
        assert_batches_equal([sx], [sy])


def _deep_equal(a, b, path="scenario"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _deep_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_womd_adapter_gives_the_jax_scenario_on_the_proto_stub():
    ours = t_adapter.scenario_from_womd_proto(_stub_scenario())
    theirs = j_adapter.scenario_from_womd_proto(_stub_scenario())
    _deep_equal(ours, theirs)
    ep_t, at_t = t_packing.pack_scenario(ours, "training", seed=0, **SMALL)
    ep_j, at_j = j_packing.pack_scenario(theirs, "training", seed=0, **SMALL)
    _deep_equal(ep_t, ep_j)
    _deep_equal(at_t, at_j, "attrs")
    assert [t_adapter.fold_tl_state(s) for s in range(9)] == [j_adapter.fold_tl_state(s) for s in range(9)]
