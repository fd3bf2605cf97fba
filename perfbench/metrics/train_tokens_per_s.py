"""Tokens of the window's whole steps over the window's time (host
clock; the window closes once every optimizer update it owes is settled
and the device is synchronised)."""


def read(w):
    return w.tokens / w.seconds
