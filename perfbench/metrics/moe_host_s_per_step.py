"""Host seconds a step the executor spends routing and dispatching
(``moe.route``) and enqueueing the expert products and their combine
(``moe.experts``): the union of the ``moe.*`` spans on ``exec.host``
inside the window's steps, over the steps."""
from harness.hostspans import host_seconds_per_step


def read(w):
    return host_seconds_per_step(w, lambda name, cat: name.startswith("moe."))
