"""Production mesh builder and the card's data-sheet constants.

Port of the JAX package's ``launch/mesh.py``. The mesh shapes are the
reference's -- one pod of 16 x 16 = 256 ranks, two pods of 2 x 16 x 16
-- so every dry-run cell has its counterpart there. The mesh is built in
a FUNCTION, never at import: it needs a default process group of that
many ranks (the dry run's ``fake`` group, or a real one).

The constants are the NVIDIA H100 SXM's data sheet (the ``"server"``
grade of ``runtime/fleet.py``): 989e12 dense bf16 FLOP/s, 3.35e12 B/s of
HBM3, and NVLink 4's 900 GB/s a GPU both ways together, 450e9 B/s each
way. A ``model`` axis of 16 spans two 8-GPU NVLink nodes, so the roofline's
collective term, which reads the NVLink figure for every byte, is
optimistic for the traffic that crosses nodes; nothing more is modelled.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The production ``DeviceMesh`` over the default process group, which
    must have 256 (512 with ``multi_pod``) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# H100 SXM data-sheet constants used by the roofline analysis
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per GPU, dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s per GPU, HBM3
NVLINK_BW = 450e9            # bytes/s per GPU, one direction
