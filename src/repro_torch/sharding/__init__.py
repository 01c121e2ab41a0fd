from repro_torch.sharding.fleet import (
    FLOW_AXIS,
    flow_sharding,
    shard_flow_schedule,
    shard_flow_objectives,
    shard_path_spec,
    shard_fleet_state,
)
from repro_torch.sharding.rules import (
    param_specs,
    cache_specs,
    batch_specs,
    opt_specs,
    to_shardings,
    batch_axes_for,
)
