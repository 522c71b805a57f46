"""Data: the synthetic corpora the training CLI draws batches from, and
the background prefetch pipeline."""

from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import (lm_batch_at, lm_batches,
                                        sst2_batches, synthetic_lm_corpus,
                                        synthetic_sst2)

__all__ = ["DataPipeline", "lm_batch_at", "lm_batches", "sst2_batches",
           "synthetic_lm_corpus", "synthetic_sst2"]
