"""Core: the seed-replay hash RNG, perturbation and update replay."""

from repro_torch.core.engine import SGD, MezoConfig, UpdateRule, update_rule
from repro_torch.core.mezo import replay_update
from repro_torch.core.perturb import add_scaled_z, leaf_salts
from repro_torch.core.rng import fold_seed, z_field

__all__ = ["MezoConfig", "SGD", "UpdateRule", "add_scaled_z", "fold_seed",
           "leaf_salts", "replay_update", "update_rule", "z_field"]
