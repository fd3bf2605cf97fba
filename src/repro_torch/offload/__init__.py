"""The tiered stores and the serving coordinators of the port. The
training offload engine arrives with the training slice."""
from repro_torch.offload.coordinators import (KVBlockCoordinator,  # noqa: F401
                                              ParameterCoordinator,
                                              tree_from_bytes, tree_to_bytes)
from repro_torch.offload.stores import (HostStore, SSDStore,  # noqa: F401
                                        TieredVector, TrafficMeter)
