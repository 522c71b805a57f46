"""Runtime: the training loop (``Trainer``); stragglers, elastic meshes
and the fleet come with later slices."""

from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
