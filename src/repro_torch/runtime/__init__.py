"""Runtime: the training loop (``Trainer``), the one-call multi-tenant
path (``train_multi_tenant``), straggler masks, elastic meshes and the
async elastic fleet."""

from repro_torch.runtime.elastic import (elastic_mesh, mesh_shape_for,
                                         remesh_params)
from repro_torch.runtime.fleet import (DirectionLease, FaultSpec,
                                       FleetCoordinator, FleetReport,
                                       FleetSim, WorkerSpec, get_grade,
                                       lease_latency_s)
from repro_torch.runtime.stragglers import StragglerPolicy
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         train_multi_tenant)

__all__ = ["Trainer", "TrainerConfig", "StragglerPolicy", "elastic_mesh",
           "mesh_shape_for", "remesh_params", "FleetCoordinator", "FleetSim",
           "FleetReport", "DirectionLease", "WorkerSpec", "FaultSpec",
           "get_grade", "lease_latency_s", "train_multi_tenant"]
