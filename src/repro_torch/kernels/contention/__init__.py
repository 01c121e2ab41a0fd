from repro_torch.kernels.contention.ops import contention_rates
