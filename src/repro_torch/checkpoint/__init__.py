from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.replay_log import ReplayLog, replay_into
from repro_torch.checkpoint.store import (latest_step, load_params,
                                          params_from_numpy,
                                          params_to_numpy, save_params)

__all__ = ["CheckpointManager", "ReplayLog", "latest_step", "load_params",
           "params_from_numpy", "params_to_numpy", "replay_into",
           "save_params"]
