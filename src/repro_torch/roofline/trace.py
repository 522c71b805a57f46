"""Per-device cost of a traced function: the counterpart of the JAX
package's ``roofline/hlo.py``.

The reference parses the optimized, SPMD-partitioned HLO of a compiled
step. The port runs eagerly, so :func:`analyze` runs the function itself
under a ``TorchDispatchMode`` and counts the ops it dispatches, on this
rank's tensors: a DTensor op is handed back to DTensor (the mode returns
``NotImplemented`` for it, as ``CommDebugMode`` does), which desugars it
into local ops on the shards and the collectives its redistributions
need, and those come back through the mode with their local shapes (the
ops DTensor runs on global-shape fake tensors only to infer an output's
metadata are not counted). So
every count is per device, and -- the port's layer loops being Python
loops -- loop-aware by construction. Run under ``FakeTensorMode`` it
allocates nothing.

  * ``flops``: dots only, ``2 * prod(result) * prod(contracted)``, as
    ``hlo.py`` counts them (``mm``, ``addmm``, ``bmm``, ``baddbmm``; an
    ``einsum`` or ``matmul`` reaches the dispatcher as one of these);
  * ``hbm_bytes``: the bytes of each op's tensor inputs and outputs, views
    and metadata excluded. It is an UNFUSED count -- every op reads its
    inputs from memory and writes its outputs back -- and is never to be
    compared with XLA's fused proxy, which charges only top-level results;
  * ``collective_bytes`` and ``coll_<kind>``: the bytes of each
    ``_c10d_functional`` collective's result (and of the legacy ``c10d``
    ops'), by the HLO kinds (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``; ``broadcast`` as itself); the
    total counts an all-reduce twice (ring traffic), as
    ``hlo.collective_bytes`` does; :attr:`Tracer.by_group` splits the
    same bytes by the process group's name (:func:`groups_crossing`
    picks the groups that span more than one index of a mesh axis);
  * ``peak_bytes`` (:attr:`Tracer.peak`): the most bytes of this rank's
    storages alive at once -- every op's outputs from their creation until
    their last tensor is freed, plus what :meth:`Tracer.track` registers
    (the step's inputs). It sees fake tensors' lifetimes as real ones'.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}

# ops that move no bytes: views, metadata, allocation-free bookkeeping
_FREE = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "select", "slice", "unsqueeze", "squeeze", "as_strided",
    "alias", "detach", "unbind", "split", "split_with_sizes", "chunk",
    "narrow", "diagonal", "view_as_real", "view_as_complex", "lift_fresh",
    "_to_copy_noop", "sym_size", "sym_stride", "sym_numel", "dim", "size",
    "stride", "is_same_size", "_local_scalar_dense", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "wait_tensor",
    "device", "set_", "resize_", "_has_compatible_shallow_copy_type",
}

_COLL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return int(t.numel()) * t.element_size()


def _tensors(x):
    leaves, _ = tree_flatten(x)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def dot_flops(name: str, args, out) -> float:
    """``2 * prod(result) * prod(contracted)`` of a dot op."""
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0.0
    return 2.0 * float(out.numel()) * float(a.shape[-1])


def _group_name(args, kwargs) -> str:
    """The ``group_name`` a ``_c10d_functional`` collective runs on (its
    last string argument); ``"unknown"`` for the legacy ``c10d`` ops,
    which carry a process-group object instead."""
    if isinstance(kwargs.get("group_name"), str):
        return kwargs["group_name"]
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else "unknown"


class Tracer(TorchDispatchMode):
    """Counts dots, bytes and collectives of what runs inside it; read
    them with :meth:`result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.by_group: Dict[str, float] = defaultdict(float)
        self.n_ops = 0
        self._muted = 0
        self._saved = None
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}      # storage -> [tensors, bytes]

    def track(self, *tensors):
        """Count ``tensors``' storages (DTensors: their shards) as live
        from now until they are freed."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._hold(getattr(t, "_local_tensor", t))

    def _hold(self, t):
        try:
            st = t.untyped_storage()
        except Exception:        # no storage (sparse, nested): not counted
            return
        key = st._cdata
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [0, int(st.nbytes())]
            self.live += ent[1]
            self.peak = max(self.peak, self.live)
        ent[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._refs[key]

    def __enter__(self):
        # DTensor infers an op's output metadata by running it on fake
        # tensors of the global shapes: mute the count while it does
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        tracer = self

        def muted(prop, op_schema):
            tracer._muted += 1
            try:
                return orig(prop, op_schema)
            finally:
                tracer._muted -= 1

        self._saved = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or self._muted:
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        self.n_ops += 1
        if name in _COLL:
            n = sum(_nbytes(t) for t in _tensors(out))
            self.coll[_COLL[name]] += n
            self.by_group[_group_name(args, kwargs)] += n
        elif name in _DOTS:
            self.flops += dot_flops(name, args, out)
        if name not in _FREE:
            self.hbm += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                         + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self._hold(t)
        return out

    def result(self) -> Dict[str, float]:
        """``hlo.analyze``'s keys: flops, hbm_bytes, collective_bytes
        (all-reduce 2x) and ``coll_<kind>``."""
        total = 0.0
        for k, v in self.coll.items():
            total += 2 * v if k == "all-reduce" else v
        out = {"flops": self.flops, "hbm_bytes": self.hbm,
               "collective_bytes": total}
        for k, v in self.coll.items():
            out[f"coll_{k}"] = v
        return out


def analyze(fn, *args, **kwargs) -> Dict[str, float]:
    """Per-device costs of ``fn(*args, **kwargs)`` (see the module
    docstring)."""
    with Tracer() as t:
        fn(*args, **kwargs)
    return t.result()


def collective_bytes(result: Dict[str, float]) -> Dict[str, int]:
    """Per-kind byte totals + 'total' (all-reduce 2x) of an
    :func:`analyze` result, as ``hlo.collective_bytes`` reports them."""
    sums = {k[5:]: int(v) for k, v in result.items()
            if k.startswith("coll_")}
    sums["total"] = int(result["collective_bytes"])
    return sums


def groups_crossing(group_names, mesh, axis: str):
    """The names among ``group_names`` whose process group holds ranks
    at more than one index of ``mesh``'s ``axis`` (e.g. the collectives
    that cross pods); an unresolvable name counts as crossing."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    along = mesh.mesh.movedim(mesh.mesh_dim_names.index(axis), 0)
    coord = {int(r): i for i, ranks in enumerate(along)
             for r in ranks.flatten()}
    out = []
    for name in group_names:
        try:
            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
        except Exception:          # a legacy op's group: not resolvable
            out.append(name)
            continue
        if len({coord.get(r) for r in ranks}) > 1:
            out.append(name)
    return out
