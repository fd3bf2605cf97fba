"""Host seconds a step the executor waits on the host optimizer's
requests: the union of its ``opt.wait`` spans (the α-tail flush waiting
on the layer's early update, the α gate, the drains) inside the window's
steps, over the steps."""
from harness.hostspans import host_seconds_per_step


def read(w):
    return host_seconds_per_step(w, lambda name, cat: name == "opt.wait")
