"""The byte models and the schedule IR the serving slice runs on
(copies of the reference's ``core.traffic``, ``core.perfmodel`` and
``core.plan``). The training schedules arrive with the training slice."""
from repro_torch.core.traffic import (  # noqa: F401
    KVTraffic,
    TrafficBreakdown,
    checkpoint_bytes,
    horizontal_traffic,
    kv_blocks,
    kv_traffic,
    model_bytes,
    optimizer_state_bytes,
    vertical_traffic,
)
from repro_torch.core.perfmodel import (  # noqa: F401
    MachineParams,
    StorageRatios,
    Workload,
)
