"""Elastic scaling for ZO training.

Port of the JAX package's ``runtime/elastic.py``. Because parameters are
replicated across the ``pod`` axis and cross-pod state is only the
per-step (seed, gs) scalars, pods joining or leaving change *nothing*
about parameter sharding -- only the direction count K:

  * pod join:  broadcast params into the new pod (one transfer), K += k
  * pod leave: K -= k, continue the same step (ZO drop-direction
    semantics)

``mesh_shape_for`` is the reference's arithmetic, stranding warning
included. ``elastic_mesh`` lays the live ``torch`` devices (every CUDA
device by default, or the ones the caller names, e.g. the CPU) out on
that shape, and ``Mesh.device_mesh`` is the ``DeviceMesh`` of that
layout over the default process group (one rank a device).
``remesh_params`` moves live parameters onto a mesh: onto a
``DeviceMesh`` of any size each leaf is distributed by the sharding plan
(``models/sharding.py``; a leaf already on another mesh is gathered
first), and on a one-device ``Mesh`` every tensor already there is kept
as it is (no copy, values untouched).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

AXES = ("pod", "data", "model")


def mesh_shape_for(n: int, model_parallel: int, data_parallel: int
                   ) -> Tuple[int, int, int]:
    """(pods, data, model) mesh shape for ``n`` live devices.

    Keeps the intra-pod (data, model) topology fixed when at least one
    full pod's devices remain, absorbing count changes into the pod
    axis; otherwise degrades to one partial pod (model axis kept, data
    axis shrunk). Devices that don't fill the shape are *stranded* --
    excluded from the mesh, silently contributing nothing -- so any
    remainder is warned about by name rather than dropped quietly.
    """
    per_pod = model_parallel * data_parallel
    if n >= per_pod:
        shape = (n // per_pod, data_parallel, model_parallel)
    else:
        dp = max(1, n // model_parallel)
        if dp * model_parallel > n:
            model_parallel, dp = n, 1
        shape = (1, dp, model_parallel)
    used = int(np.prod(shape))
    if used < n:
        warnings.warn(
            f"elastic_mesh: stranding {n - used} of {n} devices (mesh "
            f"shape {shape} uses {used}; pod size "
            f"{per_pod} = {data_parallel} data x {model_parallel} "
            f"model) -- they will sit idle until the next resize",
            RuntimeWarning, stacklevel=3)
    return shape


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: a (pods, data, model) object array of
    ``torch.device``; the axes are :data:`AXES`."""
    devices: np.ndarray
    axis_names: Tuple[str, str, str] = AXES

    def device_mesh(self, device_type: str = None):
        """The ``DeviceMesh`` of this layout over the default process
        group, whose world size must be the mesh's size."""
        from torch.distributed.device_mesh import init_device_mesh
        if device_type is None:
            device_type = next(iter(self.devices.flat)).type
        return init_device_mesh(device_type, tuple(self.devices.shape),
                                mesh_dim_names=self.axis_names)


def elastic_mesh(devices: Sequence = None, model_parallel: int = 16,
                 data_parallel: int = 16) -> Mesh:
    """Mesh for however many devices are currently alive: ``devices``
    (``torch.device`` or names such as ``"cpu"``), by default every CUDA
    device. Keeps the intra-pod (data, model) topology fixed and absorbs
    device-count changes into the pod axis; degrades to one partial pod
    below a pod's worth. Devices beyond the last full pod are stranded
    with a warning (``mesh_shape_for``)."""
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if devices is None else [torch.device(d) for d in devices])
    if not devs:
        raise RuntimeError("elastic_mesh: no live device (torch.cuda has "
                           "none); pass devices=['cpu'] to mesh the CPU")
    shape = mesh_shape_for(len(devs), model_parallel, data_parallel)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr[: int(np.prod(shape))].reshape(shape))


def remesh_params(params: Dict[str, object], new_mesh
                  ) -> Dict[str, object]:
    """Move live params onto ``new_mesh`` (pod join/leave), values
    untouched. A ``DeviceMesh``: every leaf distributed by the sharding
    plan (``sharding.spec_tree``'s defaults), a DTensor on another mesh
    gathered first. A one-device :class:`Mesh`: a
    tensor already on that device is kept as it is, any other is moved
    there."""
    if hasattr(new_mesh, "mesh_dim_names"):
        from repro_torch.models import sharding as shd
        specs = shd.param_specs(params, new_mesh)
        return {k: shd.distribute(v, new_mesh, specs[k])
                for k, v in params.items()}
    devs = set(new_mesh.devices.flat)
    if len(devs) != 1:
        raise ValueError(
            f"remesh_params: a Mesh lays out this process's one device; "
            f"this one spans {len(devs)} -- a mesh of several ranks is a "
            f"DeviceMesh (Mesh.device_mesh())")
    (dev,) = devs
    return {k: v if v.device == dev else v.to(dev)
            for k, v in params.items()}
