"""Dynamic scenarios, ported to PyTorch (port of ``repro.scenarios``):

  schedule.py   re-export of repro_torch.core.schedule
  families.py   the condition, flow-arrival and topology families (NumPy;
                a copy of the reference module)
  spec.py       ScenarioSpec and TopologySpec (JSON scenario files) and
                the domain-randomized samplers of condition tables, link
                graphs, fleet arrivals and per-flow objectives, returning a
                Workload; every NumPy draw is byte-identical to the
                reference's for the same seed
  evaluate.py   scoring on dynamic scenarios: one controller against the
                static and exploration-only baselines, a shared fleet
                policy or per-flow baselines under an arrival schedule, and
                the same over a multi-link topology
  faults.py     FaultSpec: seeded, JSON-serializable liveness faults
                (kill_flow / restart_flow / stage_hang / link_blackout)
                compiled into ScheduleTable / FlowSchedule / LinkGraph
                edits for the sim, sampled per env for training
  driver.py     ScenarioDriver (live replay of a scenario on a
                TransferEngine, SharedLink or MultiLink link) and
                FaultInjector (live replay of a FaultSpec; a copy of the
                reference module)
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
                                        sample_objectives, holdout_families,
                                        TopologySpec, sample_topology_batch)
from repro_torch.scenarios.evaluate import (EvalResult, run_in_dynamic_sim,
                                            evaluate_scenario,
                                            default_params,
                                            exploration_baseline,
                                            static_baseline,
                                            StaticController,
                                            run_fleet_in_dynamic_sim,
                                            FleetEvalResult,
                                            run_topology_in_dynamic_sim,
                                            TopologyEvalResult)
from repro_torch.scenarios.faults import (FaultEvent, FaultSpec,
                                          sample_faults, sample_fault_batch,
                                          compile_fault_batch,
                                          apply_faults_to_table,
                                          apply_faults_to_flows,
                                          apply_faults_to_graph)
from repro_torch.scenarios.driver import ScenarioDriver, FaultInjector
