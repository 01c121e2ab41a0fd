from repro_torch.kernels.sim_step.ops import sim_step_batch, sim_interval_batch
