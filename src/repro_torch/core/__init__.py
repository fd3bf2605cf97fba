"""The byte models, the schedule IR (copies of the reference's
``core.traffic``, ``core.perfmodel`` and ``core.plan``) and the in-memory
train-step builders (``core.schedules``)."""
from repro_torch.core.schedules import (  # noqa: F401
    ScheduleConfig,
    grads_fn,
    init_train_state,
    make_delayed_train_step,
    make_train_step,
)
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
