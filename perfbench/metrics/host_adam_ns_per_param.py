"""Busy nanoseconds of the host Adam's ``update`` calls (timed around
each call, summed over the I/O workers that run them) per parameter
updated, in the window."""


def read(w):
    if not w.adam_params:
        return None
    return 1e9 * w.adam_busy_s / w.adam_params
