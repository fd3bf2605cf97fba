"""The in-memory trainer (``Trainer``, ``TrainReport``) and its
layerwise checkpoints (``checkpoint.save`` / ``restore``, in the
reference's file format)."""
from repro_torch.train.loop import Trainer, TrainReport  # noqa: F401
from repro_torch.train import checkpoint  # noqa: F401
