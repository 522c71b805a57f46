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
that shape; ``remesh_params`` moves live parameters onto it. The port
places parameters on one device: a one-device mesh keeps every tensor
already there as it is (no copy, values untouched), and a mesh of more
devices is refused, since sharding a tree over several cards needs a
sharding plan (the reference's ``models/sharding.py``) that the port
does not have.
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


def remesh_params(params: Dict[str, object], new_mesh: Mesh
                  ) -> Dict[str, object]:
    """Move live params onto ``new_mesh`` (pod join/leave), values
    untouched: on a one-device mesh a tensor already on that device is
    kept as it is, any other is moved there."""
    devs = set(new_mesh.devices.flat)
    if len(devs) != 1:
        raise ValueError(
            f"remesh_params: the port places parameters on one device; "
            f"this mesh spans {len(devs)} (sharding across cards needs a "
            f"sharding plan)")
    (dev,) = devs
    return {k: v if v.device == dev else v.to(dev)
            for k, v in params.items()}
