from repro_torch.runtime.ft import (
    HeartbeatRegistry,
    StragglerDetector,
    TrainerReport,
    FaultTolerantTrainer,
    WorkerFailure,
)
from repro_torch.runtime.elastic import reshard_state, elastic_mesh
from repro_torch.runtime.compress import (make_int8_compressor,
                                         int8_roundtrip_error)
