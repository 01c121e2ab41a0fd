"""The reference's deprecated compatibility surfaces, held in the port as
the reference's own pins hold them (``tests/test_faults.py``, its legacy
section): ``Workload``'s tuple unpacking and indexing; ``train_ppo``'s
per-axis kwargs, which warn, conflict with ``workload=`` and fold into a
Workload with a bit-identical training history; a ``resample`` that
returns bare tables, which warns once; ``generator=`` (the reference's
``key=``), whose None is today's default bit for bit; and
``moe_apply(router_noise=, generator=)`` against the reference's
``router_noise`` and ``rng`` with the reference's draw passed in."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe

from repro_torch import convert
from repro_torch.core import ppo as tppo
from repro_torch.core import simulator as tsim
from repro_torch.core.workload import Workload
from repro_torch.nn import moe
from repro_torch.scenarios import sample_fleet_batch, sample_topology_batch

torch.set_num_threads(1)   # small ops: more threads only contend


def _params():
    return tsim.make_env_params(tpt=[0.2, 0.15, 0.2], bw=[1, 1, 1],
                                cap=[2, 2], n_max=50, device="cpu")


def _cfg(**kw):
    kw.setdefault("max_episodes", 6)
    kw.setdefault("n_envs", 2)
    kw.setdefault("n_flows", 2)
    kw.setdefault("max_steps", 4)
    kw.setdefault("obs_spec", tsim.FLEET_OBS)
    kw.setdefault("log_every", 0)
    kw.setdefault("device", "cpu")
    return tppo.PPOConfig(**kw)


def _fleet(seed=3):
    return sample_fleet_batch(2, 2, seed=seed, horizon=30.0,
                              device="cpu").replace(objectives=None,
                                                    specs=None)


def test_workload_iterates_and_indexes_like_the_legacy_tuple():
    wl = sample_fleet_batch(2, 3, seed=7, horizon=30.0, device="cpu")
    specs, tables, flows, objectives = wl
    assert specs is wl.specs and tables is wl.tables
    assert flows is wl.flows and objectives is wl.objectives
    assert len(wl) == 4
    assert wl[1] is wl.tables and wl[1:3] == (wl.tables, wl.flows)
    # topology batches slot the graph where tables sat
    tw = sample_topology_batch(2, 2, n_links=2, seed=7, horizon=30.0,
                               device="cpu")
    _, topo, _, _ = tw
    assert topo is tw.topology


def test_train_ppo_legacy_kwargs_warn_and_conflict():
    p = _params()
    wl = _fleet()
    with pytest.deprecated_call():
        res = tppo.train_ppo(p, _cfg(max_episodes=2), tables=wl.tables)
    assert res.episodes == 2
    with pytest.raises(ValueError, match="not both"):
        with pytest.deprecated_call():
            tppo.train_ppo(p, _cfg(max_episodes=2), workload=Workload(),
                           tables=wl.tables)


def test_legacy_kwargs_train_bit_for_bit_as_the_workload():
    """The consolidation pin: the legacy spelling runs the exact episode
    stream of ``workload=``, static axes and per-axis resamplers alike."""
    p = _params()
    wl = _fleet()
    new = tppo.train_ppo(p, _cfg(seed=1), workload=wl)
    with pytest.deprecated_call():
        old = tppo.train_ppo(p, _cfg(seed=1), tables=wl.tables,
                             flows=wl.flows)
    assert new.history == old.history

    def draw(rnd):
        return _fleet(seed=10 + rnd)

    new = tppo.train_ppo(p, _cfg(seed=2), workload=draw(0), resample=draw)
    with pytest.deprecated_call():
        old = tppo.train_ppo(
            p, _cfg(seed=2), tables=draw(0).tables,
            resample=lambda rnd: draw(rnd).tables,
            resample_flows=lambda rnd: draw(rnd).flows)
    assert new.history == old.history and len(new.history) == 6


def test_legacy_resample_of_bare_tables_warns_once():
    p = _params()
    wl = _fleet()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tppo.train_ppo(p, _cfg(max_episodes=6),
                             resample=lambda rnd: wl.tables)
    assert res.episodes == 6
    bare = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "bare tables" in str(w.message)]
    assert len(bare) == 1
    new = tppo.train_ppo(p, _cfg(max_episodes=6),
                         resample=lambda rnd: Workload(tables=wl.tables))
    assert new.history == res.history


def test_generator_none_is_todays_default_bit_for_bit():
    """None seeds from ``cfg.seed``, as a generator seeded with it does;
    another seed trains another stream."""
    p = _params()
    wl = _fleet()
    base = tppo.train_ppo(p, _cfg(seed=4), workload=wl)
    again = tppo.train_ppo(p, _cfg(seed=4), workload=wl, generator=None)
    seeded = tppo.train_ppo(p, _cfg(seed=4), workload=wl,
                            generator=torch.Generator().manual_seed(4))
    assert base.history == again.history == seeded.history
    for n, t in base.params.state_dict().items():
        assert torch.equal(t, seeded.params.state_dict()[n]), n
    other = tppo.train_ppo(p, _cfg(seed=4), workload=wl,
                           generator=torch.Generator().manual_seed(5))
    assert other.history != base.history


def test_router_noise_with_the_references_draw():
    """The reference's ``router_noise`` with an ``rng``: its noise,
    ``jax.random.normal(rng, (N, E))``, passed to the port as the draw;
    the outputs and the aux loss agree in float32, the routing exactly.
    Without a generator the port adds no noise, as the reference adds
    none without an rng."""
    E, D, FF, B, S = 4, 32, 48, 2, 24
    jp = jmoe.moe_init(jax.random.PRNGKey(0), D, FF, E, dtype=jnp.float32)
    tp = moe.MoE(D, FF, E, dtype=torch.float32)
    tp.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in
                        convert.flatten_tree(
                            jax.tree.map(np.asarray, jp)).items()})
    x = np.random.default_rng(7).normal(size=(B, S, D)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (B * S, E)))
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2,
                              router_noise=0.5, rng=key)
    draws = []

    def draw(shape, generator, device):
        draws.append(tuple(shape))
        return torch.from_numpy(noise.copy()).to(device)

    orig = moe.router_noise_draw
    moe.router_noise_draw = draw
    try:
        with torch.inference_mode():
            ty, taux = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                                     router_noise=0.5,
                                     generator=torch.Generator())
            quiet, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                                     router_noise=0.5)
            plain, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2)
    finally:
        moe.router_noise_draw = orig
    assert draws == [(B * S, E)]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert torch.equal(quiet, plain)
    assert not torch.allclose(ty, plain, rtol=0, atol=1e-3)
