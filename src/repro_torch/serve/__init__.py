"""Personalized serving: ZO-adapter store + prefill + continuous-batching
decode over a dense or paged KV cache."""

from repro_torch.serve.sampling import (greedy, sample_topk, spec_accept,
                                        step_keys)
from repro_torch.serve.adapters import (AdapterStore, BASE_USER, ZOAdapter,
                                        tree_bytes)
from repro_torch.serve.engine import (Completion, EngineStats, Request,
                                      ServeEngine)

__all__ = [
    "AdapterStore", "BASE_USER", "Completion", "EngineStats", "Request",
    "ServeEngine", "ZOAdapter", "greedy", "sample_topk", "spec_accept",
    "step_keys", "tree_bytes",
]
