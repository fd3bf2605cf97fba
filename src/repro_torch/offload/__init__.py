"""The tiered stores, the coordinators, the plan executor and the
SSD-offloaded training engine of the port."""
from repro_torch.offload.coordinators import (  # noqa: F401
    InterLayerTensorCoordinator, KVBlockCoordinator, OptimizerStepCoordinator,
    ParameterCoordinator, tree_from_bytes, tree_to_bytes)
from repro_torch.offload.engine import (OffloadConfig,  # noqa: F401
                                        OffloadEngine, offload_state)
from repro_torch.offload.executor import execute_plan  # noqa: F401
from repro_torch.offload.stores import (HostStore, SSDStore,  # noqa: F401
                                        TieredVector, TrafficMeter)
