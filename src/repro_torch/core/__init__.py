"""AutoMDT's core, ported to PyTorch: the single-flow main path, the
multi-flow fleet and the multi-link topology.

  schedule.py    ScheduleTable: piecewise-constant conditions, one table or
                 a batch (leading env axis); 1-bin constant_table
  utility.py     U = sum_i t_i / k^{n_i}; R_max; k = 1.02; flow_utility +
                 smooth deadline-miss penalty
  simulator.py   the dense schedule-native simulator with the env batch
                 written out; its substep loop is the sim_step CUDA kernel
  simref.py      Algorithm 1, faithful: the event-driven priority-queue
                 simulator, the dense simulator's oracle (a copy)
  networks.py    residual actor/critic of §IV-D + the GRU actor-critic
  fleet.py       F flows contending for one scheduled bottleneck
                 (thread-proportional shares, arrivals, per-flow objectives,
                 Jain-fairness reward); its solve is the contention CUDA
                 kernel, its buffer integration the sim_step kernel
  topology.py    F flows over PATHS of links, each link with its own
                 schedule: per-link work-conserving contention (F
                 water-fill rounds in the contention kernel), min over a
                 flow's links, routes that change at a route bin
  workload.py    the per-round training bundle (tables, flows, objectives,
                 topology, per-env fault schedules compiled by compiled())
  ppo.py         Algorithm 2: PPO on the batched simulator, single flow or
                 one shared policy over a fleet or a topology
  exploration.py random-threads logging phase -> B_i, TPT_i, b, n_i*, R_max
  marlin.py      baseline: 3 independent single-variable gradient-descent
                 optimizers (a copy)
  globus.py      baseline: static configuration (a copy)
  online.py      hybrid offline/online adaptation over the frozen policy:
                 replay buffer, per-stage residual bandit head, safety
                 rails (NumPy; a copy of the reference module)
  controller.py  production phase (§IV-F): AutoMDTController over one
                 live engine, FleetController over N engines on a
                 SharedLink, TopologyController over N engines on a
                 MultiLink; each takes online=OnlineConfig(...)
"""

from repro_torch.core.utility import (utility, stage_utility, r_max,
                                      K_DEFAULT, flow_utility, needed_rate,
                                      deadline_penalty)
from repro_torch.core.schedule import (ScheduleTable, make_table,
                                       constant_table, schedule_at,
                                       stack_tables, peak_bw,
                                       bottleneck_trace)
from repro_torch.core.simulator import (SimParams, SimEnv, make_env_params,
                                        ObservationSpec, HistorySpec,
                                        DEFAULT_OBS, CONTEXT_OBS,
                                        FLEET_OBS, OBJECTIVE_OBS,
                                        TOPOLOGY_OBS,
                                        history_init, history_push,
                                        history_flatten)
from repro_torch.core.networks import (PolicyNet, ValueNet, RNNPolicyNet,
                                       RNNValueNet, rnn_carry)
from repro_torch.core.fleet import (FleetState, FlowSchedule,
                                    make_flow_schedule, always_on,
                                    stack_flow_schedules, active_at,
                                    fleet_reset, fleet_step, fleet_observe,
                                    fleet_interval, fleet_achievable,
                                    jain_index, FlowObjective,
                                    make_flow_objective, default_objectives,
                                    stack_flow_objectives,
                                    objective_features, PRIORITY_TIERS,
                                    flow_bucket, max_concurrent_flows,
                                    pad_flow_schedule, pad_flow_objectives)
from repro_torch.core.topology import (LinkGraph, PathSpec, Topology,
                                       make_link_graph, single_link_graph,
                                       make_path_spec, all_links_path,
                                       stack_link_graphs, stack_path_specs,
                                       stack_topologies, routes_at,
                                       graph_peak_bw, link_peak_bw,
                                       TopologyState, topology_reset,
                                       topology_step, topology_observe,
                                       topology_interval, topology_features,
                                       topology_achievable, pad_path_spec)
from repro_torch.core.simref import EventSimulator
from repro_torch.core.workload import Workload
from repro_torch.core.ppo import PPOConfig, train_ppo, effective_obs_spec
from repro_torch.core.exploration import explore, ExplorationResult
from repro_torch.core.marlin import MarlinOptimizer
from repro_torch.core.globus import GlobusController
from repro_torch.core.controller import (AutoMDTController, FleetPolicy,
                                         FleetController, TopologyController)
from repro_torch.core.online import (OnlineConfig, OnlineAdapter,
                                     ReplayBuffer, ResidualBandit,
                                     OnlineFleetPolicy, realized_reward)
