"""The most loaded held expert's assignments over the mean held
expert's, from the engine's ``moe_expert_load`` counter over the window
(1: even; the step waits on its most loaded expert's products)."""


def read(w):
    moe = getattr(w, "moe", None)
    load = (moe or {}).get("moe_expert_load")
    if w.device is None or not load or sum(load) <= 0:
        return None
    return max(load) * len(load) / sum(load)
