"""Runtime: the training loop (``Trainer``) and the one-call
multi-tenant path (``train_multi_tenant``); stragglers, elastic meshes
and the fleet come with later slices."""

from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         train_multi_tenant)

__all__ = ["Trainer", "TrainerConfig", "train_multi_tenant"]
