"""Multi-tenant ZO training (the trainer-side twin of ``serve``)."""

from repro_torch.train.engine import (JobResult, TrainEngine, TrainJob,
                                      TrainStats, derive_user_seed)

__all__ = ["JobResult", "TrainEngine", "TrainJob", "TrainStats",
           "derive_user_seed"]
