"""The byte models, the schedule IR, the Algorithm-1 LP configuration
search (copies of the reference's ``core.traffic``, ``core.perfmodel``,
``core.plan`` and ``core.lp_search``) and the in-memory train-step
builders (``core.schedules``)."""
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
from repro_torch.core.lp_search import (  # noqa: F401
    LPSolution,
    SearchResult,
    find_optimal_config,
    solve_config,
)
