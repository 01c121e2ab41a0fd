from repro_torch.transfer.engine import (
    TransferEngine,
    SyntheticSource,
    FileSource,
    NullSink,
    ChecksumSink,
    FileSink,
    StageThrottle,
    FlowGate,
    SharedLink,
    PathGate,
    MultiLink,
)
from repro_torch.transfer.recovery import (
    RetryPolicy,
    CircuitBreaker,
    acquire_with_retry,
    FlowCursor,
    CursorSink,
    ResumableSource,
    save_cursor,
    load_cursor,
    CheckpointedFlow,
)
