"""Data: the synthetic corpora the training CLI draws batches from."""

from repro_torch.data.synthetic import (lm_batch_at, lm_batches,
                                        sst2_batches, synthetic_lm_corpus,
                                        synthetic_sst2)

__all__ = ["lm_batch_at", "lm_batches", "sst2_batches",
           "synthetic_lm_corpus", "synthetic_sst2"]
