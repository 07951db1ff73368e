"""The mesh of the port (counterpart of `iip_uavsal_saliency_tpu/parallel/`):
ranks, their spawn and collectives, and `make_mesh`'s data and spatial
axes (`mesh.py`); image rows over the spatial axis's ranks (`spatial.py`);
and train-mode BatchNorm over every rank's batch (`batchnorm.py`)."""

from . import spatial
from .batchnorm import cross_rank_batch_norm
from .mesh import Axis, Mesh, RankGroup, batch_group, batch_over, init_ranks, make_mesh, spawn

__all__ = ["Axis", "Mesh", "RankGroup", "batch_group", "batch_over", "cross_rank_batch_norm",
           "init_ranks", "make_mesh", "spatial", "spawn"]
