"""GiB a step through the SSD tier, read and written, from the engine's
byte meters (routes ``cpu->ssd`` and ``ssd->cpu``)."""


def read(w):
    return w.ssd_bytes / w.steps / 2 ** 30
