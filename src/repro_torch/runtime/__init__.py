from repro_torch.runtime.ft import (
    HeartbeatRegistry,
    StragglerDetector,
    TrainerReport,
    FaultTolerantTrainer,
    WorkerFailure,
)
