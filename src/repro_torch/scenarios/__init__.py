"""Dynamic scenarios, ported to PyTorch (port of ``repro.scenarios``):

  schedule.py   re-export of repro_torch.core.schedule
  families.py   the condition, flow-arrival and topology families (NumPy;
                a copy of the reference module)
  spec.py       ScenarioSpec (JSON scenario files) and the domain-
                randomized samplers of condition tables, fleet arrivals
                and per-flow objectives, returning a Workload; every NumPy
                draw is byte-identical to the reference's for the same seed
  evaluate.py   scoring of a shared fleet policy or per-flow baselines on
                one scenario and arrival schedule (utilization, Jain,
                deadline hits)

Not ported yet: TopologySpec/sample_topology_batch (topology slice),
faults.py and the fault_mix draws (fault slice), driver.py
(ScenarioDriver, FaultInjector) and the single-flow evaluation harness.
"""

from repro_torch.scenarios.schedule import (ScheduleTable, make_table,
                                            constant_table, schedule_at,
                                            stack_tables, table_to_numpy,
                                            peak_bw, bottleneck_trace,
                                            horizon_seconds)
from repro_torch.scenarios.families import (FAMILIES, ARRIVAL_FAMILIES,
                                            TOPOLOGY_FAMILIES)
from repro_torch.scenarios.spec import (ScenarioSpec, default_specs,
                                        sample_scenario_batch,
                                        arrival_schedule, sample_fleet_batch,
                                        sample_objectives, holdout_families)
from repro_torch.scenarios.evaluate import (run_fleet_in_dynamic_sim,
                                            FleetEvalResult)
