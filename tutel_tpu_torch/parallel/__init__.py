"""Parallel layouts (counterpart: tutel_tpu/parallel/__init__.py): the MoE
mesh and the hierarchical mesh as process groups. The pipeline schedules
belong to a later slice."""

from .mesh import (HierarchicalMesh, MoeMesh, ProcessMesh,  # noqa: F401
                   default_ranks, infer_num_hosts)
