"""The tiered stores, the coordinators, the plan executor, the
SSD-offloaded training engines of the port (single-rank and
data-parallel), the online autotuner, crash-consistent checkpoints and
the pinned-buffer packing DP."""
from repro_torch.offload.autotune import (AutotuneConfig,  # noqa: F401
                                          AutotuneController,
                                          route_seconds_error)
from repro_torch.offload.buffers import (naive_padded, pack,  # noqa: F401
                                         waste_ratio)
from repro_torch.offload.checkpoint import (CheckpointError,  # noqa: F401
                                            load_manifest, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.offload.coordinators import (  # noqa: F401
    ActivationCoordinator, InterLayerTensorCoordinator, KVBlockCoordinator,
    LayerResiduals, OptimizerStepCoordinator, ParameterCoordinator,
    tree_from_bytes, tree_to_bytes)
from repro_torch.offload.dp import (DataParallelOffloadEngine,  # noqa: F401
                                    shard_bounds)
from repro_torch.offload.engine import (OffloadConfig,  # noqa: F401
                                        OffloadEngine, offload_state)
from repro_torch.offload.executor import execute_plan  # noqa: F401
from repro_torch.offload.stores import (HostStore, SSDStore,  # noqa: F401
                                        TieredVector, TrafficMeter)
