"""The open check of bench_faults' bar (ROADMAP.md, queue 3): whether the
port's 0.984x (fault-trained against frozen, deficit ratio, one seed on
the card) comes from the port or from training.

Both actors of ``benchmarks/bench_faults.py`` are trained in the
reference at its ``--quick`` size (96 episodes, 8 envs, 3 flows, a 40 s
training horizon), their parameters copied into torch, and every actor
scored on bench_faults' eval world at its own 60 s horizon in both
packages, with the reference's ``fault_metrics``: the deficits agree
within the fleet's tolerance when the port scores as the reference does
(the reference's initial threads handed to the port, as the fleet's
evaluation tests hand them). Marked ``slow``, as the live and benchmark
tests are: it trains two agents in the reference (about half a minute on
one CPU core).

    PYTHONPATH=src python -m pytest tests/test_torch_bench_faults_bar.py \\
        -m slow -s
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks import bench_faults as bf      # noqa: E402
from benchmarks.bench_fleet import independent_controllers  # noqa: E402
import repro.scenarios as jsc                  # noqa: E402
from repro.core import simulator as jsim       # noqa: E402

from repro_torch.convert import params_from_jax                  # noqa: E402
from repro_torch.core import simulator as tsim, GlobusController  # noqa: E402
from repro_torch.core.controller import (AutoMDTController,      # noqa: E402
                                         FleetPolicy)
import repro_torch.scenarios as tsc            # noqa: E402

HORIZON, F = 60.0, 3       # bench_faults' horizon; its --quick fleet size
TOL = 1e-4                 # deficits, from goodput held within 1e-5


class _Faulted:
    """bench_faults' ``_FaultedSpec`` on the port's tables."""

    def __init__(self, table):
        self.name, self.horizon, self._table = "faulted", HORIZON, table

    def table(self, *, device=None):
        return self._table


def _port_world():
    """bench_faults' eval_world, built with the port's scenario modules."""
    base = tsc.ScenarioSpec(family="static", seed=11, horizon=HORIZON,
                            base_tpt=bf.BASE_TPT, base_bw=bf.BASE_BW)
    flows = tsc.arrival_schedule("always_on", F, horizon=HORIZON, seed=11,
                                 device="cpu")
    spec = tsc.FaultSpec(name="bench", events=[
        tsc.FaultEvent(kind="kill_flow", t=0.25 * HORIZON, flow=F - 1),
        tsc.FaultEvent(kind="stage_hang", t=0.45 * HORIZON,
                       until=0.55 * HORIZON, stage=1),
        tsc.FaultEvent(kind="restart_flow", t=0.65 * HORIZON, flow=F - 1)])
    table = tsc.apply_faults_to_table(spec, base.table(device="cpu"))
    return _Faulted(table), tsc.apply_faults_to_flows(spec, flows)


@pytest.mark.slow
def test_bench_faults_deficits_agree_across_packages(monkeypatch):
    torch.set_num_threads(1)
    # the reference's initial threads (a jax.random draw at seed 7) handed
    # to the port's reset, as tests/test_torch_fleet_eval.py does
    import jax
    from repro_torch.scenarios import evaluate
    draw = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (F, 3), 1,
                                         16), np.float32)
    real = evaluate.fleet_reset
    monkeypatch.setattr(evaluate, "fleet_reset", lambda *a, generator=None,
                        **kw: real(*a, threads=torch.from_numpy(draw)[None],
                                   **kw))
    t0 = time.time()
    jenv = jsim.make_env_params(tpt=list(bf.BASE_TPT), bw=list(bf.BASE_BW),
                                cap=[2.0, 2.0], n_max=bf.N_MAX)
    fault_pol, res = bf.train_fault_agent(jenv, seed=1, episodes=96,
                                          n_envs=8, n_flows=F, horizon=40.0)
    indep = bf.train_independent_agent(jenv, seed=1, episodes=96, n_envs=8)
    train_s = time.time() - t0

    spec, flows, t_fail, t_back = bf.eval_world(HORIZON, F)
    share = tuple(b / F for b in bf.BASE_BW)
    jobj = jsc.sample_objectives(F, seed=11, horizon=HORIZON, base_bw=share)
    ref = {"fault_trained": jsc.run_fleet_in_dynamic_sim(
        spec, flows, jenv, fault_pol, seed=7, label="fault_trained",
        objectives=jobj, apply_floors=False)}
    for kind, label in (("automdt_indep", "automdt_frozen"),
                        ("static", "static")):
        ref[label] = jsc.run_fleet_in_dynamic_sim(
            spec, flows, jenv,
            independent_controllers(kind, indep.params["policy"], F),
            seed=7, label=label, objectives=jobj, apply_floors=False)

    tenv = tsim.make_env_params(tpt=list(bf.BASE_TPT), bw=list(bf.BASE_BW),
                                cap=[2.0, 2.0], n_max=bf.N_MAX,
                                device="cpu")
    tfault = params_from_jax(res.params, device="cpu")["policy"]
    tindep = params_from_jax(indep.params, device="cpu")["policy"]
    fleet_spec = tsim.ObservationSpec(**fault_pol.obs_spec._asdict())
    ctx_spec = tsim.ObservationSpec(**jsim.CONTEXT_OBS._asdict())
    actors = {
        "fault_trained": FleetPolicy(tfault, n_max=bf.N_MAX,
                                     deterministic=True, obs_spec=fleet_spec,
                                     device="cpu"),
        "automdt_frozen": [AutoMDTController(
            tindep, n_max=bf.N_MAX, bw_ref=float(max(bf.BASE_BW)),
            deterministic=True, obs_spec=ctx_spec, device="cpu")
            for _ in range(F)],
        "static": [GlobusController() for _ in range(F)]}
    tspec, tflows = _port_world()
    tobj = tsc.sample_objectives(F, seed=11, horizon=HORIZON, base_bw=share,
                                 device="cpu")
    duration = float(jenv.duration)
    deficits = {}
    for label, actor in actors.items():
        got = tsc.run_fleet_in_dynamic_sim(
            tspec, tflows, tenv, actor, seed=7, label=label,
            objectives=tobj, apply_floors=False)
        want = ref[label]
        d_got = bf.fault_metrics(got, duration, t_fail, t_back)[1]
        d_want = bf.fault_metrics(want, duration, t_fail, t_back)[1]
        deficits[label] = (d_got, d_want)
        np.testing.assert_allclose(np.asarray(got.goodput),
                                   np.asarray(want.goodput), atol=1e-5,
                                   rtol=0, err_msg=label)
        assert abs(d_got - d_want) <= TOL * max(1.0, d_want), (label,
                                                               d_got, d_want)
    ratio = {pkg: deficits["automdt_frozen"][i]
             / max(deficits["fault_trained"][i], duration / 2)
             for i, pkg in enumerate(("port", "reference"))}
    print(f"[bench_faults bar] reference training {train_s:.1f} s; "
          f"deficits (port, reference): {deficits}; frozen / fault-trained "
          f"{ratio}")
