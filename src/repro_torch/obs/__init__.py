"""repro_torch.obs — the span tracer (a copy of the reference's) and
the engines' versioned metrics snapshots."""
from repro_torch.obs.registry import (SNAPSHOT_VERSION,  # noqa: F401
                                      build_serve_snapshot, build_snapshot)
from repro_torch.obs.tracer import (CAT_HINT, CAT_IO_CHUNK,  # noqa: F401
                                    CAT_IO_QUEUE, CAT_IO_REQ,
                                    CAT_IO_REQ_QUEUE, CAT_PLAN, Tracer)
