"""Data parallelism over videos (counterpart of the `data` axis of
`iip_uavsal_saliency_tpu/parallel/`): ranks, their spawn and collectives
(`mesh.py`), and train-mode BatchNorm over every rank's batch
(`batchnorm.py`)."""

from .batchnorm import cross_rank_batch_norm
from .mesh import RankGroup, batch_group, batch_over, init_ranks, spawn

__all__ = ["RankGroup", "batch_group", "batch_over", "cross_rank_batch_norm", "init_ranks",
           "spawn"]
