"""The port's scenario samplers against the JAX package's: every NumPy
draw — condition tables, arrival schedules, objectives, on their separate
streams — must come out byte for byte the same for the same seed."""

import numpy as np
import pytest
import torch

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro import scenarios as jsc

from repro_torch import scenarios as tsc


def _same_bytes(got, want):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _same_workload(got, want):
    for a, b in zip(got.tables, want.tables):
        _same_bytes(a, b)
    for a, b in zip(got.flows, want.flows[:2]):
        _same_bytes(a, b)
    for a, b in zip(got.objectives, want.objectives):
        _same_bytes(a, b)
    assert [s.to_dict() for s in got.specs] == \
        [s.to_dict() for s in want.specs]


CASES = [dict(seed=0), dict(seed=17, objective_mix=True),
         dict(seed=3, objective_mix={"deadline_prob": 0.9,
                                     "floor_deadline_frac": 0.1}),
         dict(seed=5, families=("static", "step", "bursty", "random_walk"),
              objective_mix=True, pad_flows=True),
         dict(seed=2029, arrival_families=("poisson_arrivals",),
              horizon=40.0)]


@pytest.mark.parametrize("case", CASES, ids=[str(c["seed"]) for c in CASES])
def test_sample_fleet_batch_is_byte_identical(case):
    n_flows = 5 if case.get("pad_flows") else 4
    got = tsc.sample_fleet_batch(6, n_flows, device="cpu", **case)
    want = jsc.sample_fleet_batch(6, n_flows, **case)
    _same_workload(got, want)
    assert got.flows.t_start.shape == (6, 8 if case.get("pad_flows") else 4)


@pytest.mark.parametrize("family", sorted(jsc.ARRIVAL_FAMILIES))
def test_arrival_schedules_and_condition_tables_are_byte_identical(family):
    got = tsc.arrival_schedule(family, 9, horizon=50.0, seed=4, device="cpu")
    want = jsc.arrival_schedule(family, 9, horizon=50.0, seed=4)
    _same_bytes(got.t_start, want.t_start)
    _same_bytes(got.t_end, want.t_end)
    specs, tables = tsc.sample_scenario_batch(5, seed=8, device="cpu")
    jspecs, jtables = jsc.sample_scenario_batch(5, seed=8)
    for a, b in zip(tables, jtables):
        _same_bytes(a, b)
    spec = tsc.ScenarioSpec.from_json(specs[2].to_json())
    assert spec.to_dict() == jspecs[2].to_dict()


def test_holdout_split_and_unported_axes():
    assert tsc.holdout_families(["step"]) == jsc.holdout_families(["step"])
