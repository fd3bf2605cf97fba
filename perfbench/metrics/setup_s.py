"""Seconds from the process's start to the window's: imports, kernel
builds (first run of a checkout) or their cache, weights made on the
device, the engine built, and the checked steps that warm every shape."""


def read(w):
    return w.setup_s
