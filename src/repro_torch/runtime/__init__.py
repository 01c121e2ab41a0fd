from repro_torch.runtime.ft import HeartbeatRegistry, WorkerFailure
