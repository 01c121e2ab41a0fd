"""AutoMDT's core, ported to PyTorch: the single-flow main path.

  schedule.py    ScheduleTable: piecewise-constant conditions, one table or
                 a batch (leading env axis); 1-bin constant_table
  utility.py     U = sum_i t_i / k^{n_i}; R_max; k = 1.02; flow_utility +
                 smooth deadline-miss penalty
  simulator.py   the dense schedule-native simulator with the env batch
                 written out; its substep loop is the sim_step CUDA kernel
  networks.py    residual actor/critic of §IV-D + the GRU actor-critic
  workload.py    the per-round training bundle (tables axis)
  ppo.py         Algorithm 2: single-flow PPO on the batched simulator
  exploration.py random-threads logging phase -> B_i, TPT_i, b, n_i*, R_max
  controller.py  production phase (§IV-F): AutoMDTController over one
                 live engine
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
                                        history_init, history_push,
                                        history_flatten)
from repro_torch.core.networks import (PolicyNet, ValueNet, RNNPolicyNet,
                                       RNNValueNet, rnn_carry)
from repro_torch.core.workload import Workload
from repro_torch.core.ppo import PPOConfig, train_ppo, effective_obs_spec
from repro_torch.core.exploration import explore, ExplorationResult
from repro_torch.core.controller import AutoMDTController, FleetPolicy
