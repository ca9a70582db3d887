"""Session bootstrap, timing and path utilities
(counterpart: tutel_tpu/system.py).

`init_data_model_parallel` starts `torch.distributed` for a run (one
process a rank) and returns its `ParallelEnv`: from an explicit
`init_method` with `rank` and `world_size`, else from the environment
`torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); an already
initialized group is taken as it is. The backend follows the device the
caller asks for: "nccl" for cuda, "gloo" for cpu; a group whose backend
does not match the device raises. With no group and no environment the
run is a world of one rank and no group.

Meshes of the env (`moe_mesh`, `hierarchical_mesh`) are
`parallel.mesh` layouts over the world's ranks, whose `build()` makes the
process groups.
"""

import contextlib
import dataclasses
import os
import re
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import trace
from .parallel import mesh as mesh_lib
from .utils import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class ParallelEnv:
    """One run's world: its ranks and device, and the data x model group
    factoring."""
    ranks: tuple
    global_size: int
    group_count: int          # number of data-parallel groups
    model_size: int           # ranks per group
    global_rank: int          # this process's rank (0 without a group)
    is_distributed: bool
    device: torch.device
    backend: Optional[str]    # None without a process group

    def dist_print(self, *args):
        if self.global_rank == 0:
            print(*args)

    def moe_mesh(self, num_global_experts: int,
                 adaptive_r: int = 1) -> mesh_lib.MoeMesh:
        w = self.global_size
        sharded = max(1, w // num_global_experts) \
            if num_global_experts < w else 1
        return mesh_lib.MoeMesh(
            ranks=self.ranks, num_expert_groups=w // sharded,
            sharded_count=sharded,
            adaptive_r=min(adaptive_r, sharded) if adaptive_r else 0)

    def hierarchical_mesh(self, num_hosts: Optional[int] = None):
        return mesh_lib.HierarchicalMesh(
            self.ranks, mesh_lib.infer_num_hosts(self.ranks, num_hosts))


_LOCAL_SESSION = None


def init_data_model_parallel(group_count=1, backend=None, device="cuda",
                             init_method=None, rank=None,
                             world_size=None) -> ParallelEnv:
    """Start (or join) the process group and record the data x model
    factoring: `group_count=-k` means groups of k ranks."""
    global _LOCAL_SESSION
    device = resolve_device(device)
    maybe_init_distributed(device, backend, init_method, rank, world_size)
    if dist.is_initialized():
        running = dist.get_backend()
        if running != BACKENDS[device.type]:
            raise ValueError(f"the process group runs {running!r}, which "
                             f"does not serve device {device.type!r}")
        world, me = dist.get_world_size(), dist.get_rank()
    else:
        running, world, me = None, 1, 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if group_count < 0:
        group_count = world // -group_count
    if group_count <= 0 or world % group_count:
        raise ValueError(f"Expected to evenly divide {world} ranks into "
                         f"{group_count} groups.")
    env = ParallelEnv(ranks=tuple(range(world)), global_size=world,
                      group_count=group_count,
                      model_size=world // group_count, global_rank=me,
                      is_distributed=world > 1, device=device,
                      backend=running)
    _LOCAL_SESSION = env
    return env


def maybe_init_distributed(device="cuda", backend=None, init_method=None,
                           rank=None, world_size=None):
    """Start the process group once, from an explicit `init_method` (with
    `rank` and `world_size`) or from the environment that the launcher
    (`launcher.run`) and torchrun set: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, and LOCAL_RANK, which picks the card. Returns
    whether a group is running. Without either source, or with a group
    already running, it starts nothing (counterpart:
    tutel_tpu/system.py:89, whose `jax.distributed.initialize` gives every
    process the global view)."""
    device = resolve_device(device)
    if not dist.is_initialized() and (
            init_method is not None or "WORLD_SIZE" in os.environ):
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                       else os.environ.get("RANK", 0)))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            backend or BACKENDS[device.type],
            init_method=init_method or "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size)
    return dist.is_initialized()


def get_local_session() -> ParallelEnv:
    """The last env `init_data_model_parallel` returned (made with its
    defaults, on the GPU, when there is none)."""
    global _LOCAL_SESSION
    if _LOCAL_SESSION is None:
        _LOCAL_SESSION = init_data_model_parallel()
    return _LOCAL_SESSION


def destroy():
    """Destroy the process group (and the session), so the process can
    exit; a no-op without one."""
    global _LOCAL_SESSION
    _LOCAL_SESSION = None
    mesh_lib._GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def record_time(sync_value=None):
    """Wall time after the card's outstanding work: synchronizes the card
    when `sync_value` is a CUDA tensor, or when it is None and CUDA is in
    use."""
    if isinstance(sync_value, torch.Tensor):
        if sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


@contextlib.contextmanager
def profile_trace(log_dir):
    """A torch.profiler trace of the enclosed region (CPU and, when in use,
    CUDA activity), written to `log_dir` as a Chrome trace. The port's
    spans record inside it; `trace.records()` holds them afterwards."""
    from torch.profiler import ProfilerActivity, profile
    trace.clear()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        record_time()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def apply_rank_size_from_pattern(pattern, rank, size):
    original = pattern
    pattern = pattern.replace("{rank}", str(rank)).replace("{size}", str(size))
    if re.search(r"\{rank\}|\{size\}", original) is None and size > 1:
        raise ValueError(
            "checkpoint path must contain {rank}/{size} patterns for "
            "multi-file checkpoints: %s" % original)
    return pattern


# a process-wide key/value store (l_aux collection and the like)
_CACHE = {}


def cache(key, default=None):
    return _CACHE.setdefault(key, default)


def cache_set(key, value):
    _CACHE[key] = value
    return value


def cache_clear():
    _CACHE.clear()


def save(t, path):
    """A tensor to `path` (.npy); bfloat16 is stored as float32."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    np.save(path if path.endswith(".npy") else path + ".npy", t.numpy())


def load(path, device=None):
    """The tensor `save` wrote, on `device` (the CPU by default)."""
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def init_affinity_at_program_beginning():
    """No-op: the process's CPU and NUMA placement is left to the
    launcher."""
    return None
