"""Core: the seed-replay hash RNG, perturbation (swept and fused), the
ZO engine (direction estimators x update rules) and replay."""

from repro_torch.core.engine import (SGD, MezoAux, MezoConfig, TrainState,
                                     UpdateRule, build_strategy,
                                     get_strategy, update_rule)
from repro_torch.core.mezo import (mezo_momentum_step, mezo_step,
                                   mezo_step_fused, mezo_step_vmapdir,
                                   replay_update, spsa_gradient_estimate)
from repro_torch.core.perturb import add_scaled_z, leaf_salts
from repro_torch.core.perturb_ctx import PerturbCtx
from repro_torch.core.rng import fold_seed, z_field

__all__ = ["MezoAux", "MezoConfig", "PerturbCtx", "SGD", "TrainState",
           "UpdateRule", "add_scaled_z", "build_strategy", "fold_seed",
           "get_strategy", "leaf_salts", "mezo_momentum_step", "mezo_step",
           "mezo_step_fused", "mezo_step_vmapdir", "replay_update",
           "spsa_gradient_estimate", "update_rule", "z_field"]
