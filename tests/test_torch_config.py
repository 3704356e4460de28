"""The port's copies of the JAX-free modules: config dataclasses and synthetic data.

Both must stay identical to the JAX package's: one experiment description
and one synthetic batch drive both packages in every parity test.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
from trafficbots_tpu import config as jcfg
from trafficbots_tpu.data.synthetic import synthetic_episode_batch as j_synth
from trafficbots_tpu_torch import config as tcfg
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch as t_synth


def test_experiment_config_equal():
    assert dataclasses.asdict(tcfg.ExperimentConfig()) == dataclasses.asdict(jcfg.ExperimentConfig())


@pytest.mark.parametrize("name", ["simnet", "trafficsim", "bc", "pe_add", "no_goal", "latent_cat"])
def test_ablation_configs_equal(name):
    assert dataclasses.asdict(tcfg.ablation(name)) == dataclasses.asdict(jcfg.ablation(name))


def test_config_round_trip():
    d = tcfg.config_to_dict(tcfg.ExperimentConfig(seed=7))
    assert tcfg.config_from_dict(d) == tcfg.ExperimentConfig(seed=7)
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"no_such_key": 1})


def test_data_config_properties_equal():
    for name in ("agent_attr_dim", "map_attr_dim", "tl_attr_dim"):
        assert getattr(tcfg.DataConfig(), name) == getattr(jcfg.DataConfig(), name)


@pytest.mark.parametrize("with_agent_no_sim", [False, True])
def test_synthetic_batches_identical(with_agent_no_sim):
    kw = dict(
        n_step=21, n_step_history=11, n_agent=48, n_agent_no_sim=8, n_pl=1024,
        n_pl_node=6, n_tl=6, n_tl_stop=6,
    )
    a = j_synth(jcfg.DataConfig(**kw), n_scene=1, seed=0, n_valid_pl=768, n_valid_agent=40,
                with_agent_no_sim=with_agent_no_sim)
    b = t_synth(tcfg.DataConfig(**kw), n_scene=1, seed=0, n_valid_pl=768, n_valid_agent=40,
                with_agent_no_sim=with_agent_no_sim)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
