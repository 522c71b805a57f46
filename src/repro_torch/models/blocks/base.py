"""The Block protocol and registry -- one contract for every mixer/FFN.

Port of the JAX package's ``models/blocks/base.py``. A block implements,
over plain param dicts (one layer's slice):

  apply(cfg, p, x, rc, ctx=None)     -> (y, aux)        (full sequence)
  state_spec(cfg, bsz, max_len, dt)  -> {name: (shape, dtype)}
  prefill(cfg, p, state, x, rc)      -> (y, new_state)  (multi-token)
  decode_step(cfg, p, state, x, rc)  -> (y, new_state)  (one token)
  verify(cfg, p, state, x, rc)       -> (y, new_state)  (paged window)

The runtime owns the residual pattern: ``apply`` receives the *normed*
input and returns only the branch output. ``state_spec`` declares
per-layer state without the layer axis; the runtime stacks each leaf to
``(n_layers, B, ...)``. State is updated in place (the returned dict
holds the same tensors), which saves a cache copy per layer and step; a
recurrent block (mamba, rwkv) computes its new state and writes it back
with :func:`commit_state`, which keeps the old state of the slots that
``rc.write_mask`` masks. ``mutable_state=False`` marks state that decode
reads and never writes (cross-attention K/V). Parameter init lives in
``models/transformer.py`` for the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call inputs shared by every block of a stack (all optional)."""
    positions: Any = None      # (B, S) int positions (full / prefill)
    pos: Any = None            # (B,) per-slot position
    kv_mask: Any = None        # (B, T) key-validity mask (full mode)
    enc_out: Any = None        # (B, T_enc, D) encoder output (cross-attn)
    pages: Any = None          # (B, n_live) int32 physical page ids
    write_mask: Any = None     # (B,) bool: slots allowed to write state


@dataclasses.dataclass(frozen=True)
class BlockType:
    name: str
    apply: Callable                      # (cfg, p, x, rc, ctx=, **opts)
    state_spec: Optional[Callable] = None
    prefill: Optional[Callable] = None   # (cfg, p, state, x, rc, **opts)
    decode_step: Optional[Callable] = None
    mutable_state: bool = True
    # per-token state that lives in a shared page pool: (cfg, dtype) ->
    # {name: (per-position shape, dtype)}; the runtime builds (n_layers,
    # n_pages, page_size, *shape) pool leaves read/written via rc.pages
    paged_state_spec: Optional[Callable] = None
    # chunked prefill straight into the page pool: (cfg, p, state,
    # x(B, C, D), rc, **opts) -> (y, new_state)
    prefill_paged: Optional[Callable] = None
    # speculative-verify window: (cfg, p, state, x(B, W, D), rc, **opts)
    # -> (y, new_state), scoring W candidate tokens at positions
    # rc.pos .. rc.pos + W - 1 in one call (causal within the window);
    # rc.write_mask is (B, W). Recurrent blocks have none: the runtime
    # scans their decode_step over the window and keeps one state
    # snapshot an offset
    verify: Optional[Callable] = None

    @property
    def stateful(self) -> bool:
        return self.state_spec is not None


def commit_state(state: Dict[str, Any], new: Dict[str, Any],
                 write_mask=None) -> Dict[str, Any]:
    """Write a recurrent block's new state into its cache layer in place;
    a slot that ``write_mask`` (B,) masks keeps its old state (the JAX
    engine's masked merge). Returns ``state``."""
    if write_mask is not None and write_mask.dim() != 1:
        raise ValueError("recurrent state advances whole windows: "
                         f"write_mask must be (B,), got "
                         f"{tuple(write_mask.shape)}")
    for name, t in new.items():
        old = state[name]
        t = t.to(old.dtype)
        if write_mask is not None:
            m = write_mask.reshape(-1, *([1] * (old.dim() - 1)))
            t = torch.where(m, t, old)
        old.copy_(t)
    return state


_BLOCKS: Dict[str, BlockType] = {}


def register_block(bt: BlockType) -> BlockType:
    _BLOCKS[bt.name] = bt
    return bt


def get_block(name: str) -> BlockType:
    if name not in _BLOCKS:
        raise ValueError(f"unknown block type {name!r}; "
                         f"registered: {block_names()}")
    return _BLOCKS[name]


def block_names():
    return sorted(_BLOCKS)
