"""Parallel layouts and schedules (counterpart:
tutel_tpu/parallel/__init__.py): the MoE mesh and the hierarchical mesh as
process groups, and the GPipe and 1F1B pipelines."""

from .mesh import (HierarchicalMesh, MoeMesh, ProcessMesh,  # noqa: F401
                   default_devices, default_ranks,
                   infer_num_hosts)
from .pipeline import (local_stage_params, pipeline,  # noqa: F401
                       pipeline_1f1b, stack_stage_params)
