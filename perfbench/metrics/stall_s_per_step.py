"""The executor's host seconds a step in the plan ops that block on a
coordinator or the card: the engine's ``op_seconds`` summed over the
benchmark's own list of those ops, so that a change to the program's
list moves no reading."""

STALL_OPS = ("FETCH_PARAM", "ALLGATHER", "FETCH_CKPT", "FETCH_CKPT_BWD",
             "FETCH_ACT", "FETCH_GRAD", "GRAD_FETCH_ACC", "WAIT_OPT",
             "BARRIER")


def read(w):
    return sum(w.op_seconds.get(op, 0.0) for op in STALL_OPS) / w.steps
