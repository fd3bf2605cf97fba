"""repro_torch.obs — the span tracer (a copy of the reference's), the
engines' versioned metrics snapshots, and plan-vs-actual reconciliation
(``reconcile``: a snapshot's measured bytes against ``plan_traffic``
exactly, its route seconds against ``perfmodel.route_seconds``, and the
stall attribution by stream)."""
from repro_torch.obs.reconcile import (STALL_STREAM,  # noqa: F401
                                       Reconciliation, ReconRow, reconcile,
                                       stall_by_stream, top_stall_stream)
from repro_torch.obs.registry import (SNAPSHOT_VERSION,  # noqa: F401
                                      build_serve_snapshot, build_snapshot,
                                      traffic_maps)
from repro_torch.obs.tracer import (CAT_COPY, CAT_HINT,  # noqa: F401
                                    CAT_IO_CHUNK, CAT_IO_QUEUE, CAT_IO_REQ,
                                    CAT_IO_REQ_QUEUE, CAT_OPT, CAT_PLAN,
                                    CAT_SYNC, HOST_TRACK, Tracer)
