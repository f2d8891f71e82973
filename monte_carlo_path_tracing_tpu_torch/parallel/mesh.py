"""Device meshes, row sharding and multi-process bring-up on torch.distributed.

Counterpart of ``monte_carlo_path_tracing_tpu/parallel/mesh.py``. The
renderer's two mesh axes are the JAX package's:

  - ``tiles``: pixels / ray batches split across ranks (rays never talk);
  - ``spp``: independent sample streams of the same pixels, averaged with
    an all-reduce over the axis.

The design is PyTorch's usual SPMD style: one process per device, every
rank runs the same program, and a mesh is a ``DeviceMesh`` over the
default process group. Backends: NCCL on the card, gloo on the CPU. Gloo
also carries CUDA tensors (staged through the host), which is how several
ranks can share one card; NCCL refuses that. A caller names the backend;
nothing here falls back from one to the other.
"""

from __future__ import annotations

import datetime
import math
import os
import re
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from monte_carlo_path_tracing_tpu_torch.utils.profiling import span

AXIS_TILES = "tiles"
AXIS_SPP = "spp"

#: jax.sharding.Mesh's counterpart.
Mesh = DeviceMesh


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (AXIS_TILES,),
) -> Mesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the default group
    (``init_device_mesh``): CUDA under NCCL, CPU under gloo. ``shape`` None
    puts every rank on the first axis. Like JAX's, it raises when the shape
    needs more ranks than there are; unlike JAX's, which can take a subset
    of the devices, it also raises when it leaves a rank out, since every
    rank runs the same program."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_distributed_if_needed or init_process_group)")
    world = dist.get_world_size()
    if shape is None or len(shape) == 0:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh shape {shape} leaves {world - n} of {world} ranks out")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: Mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``); 0
    for an axis the mesh does not have."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def ray_sharding(mesh: Mesh, axis: str = AXIS_TILES):
    """DTensor placements of a [N, ...] ray array split over ``axis`` and
    replicated over the others: JAX's ``NamedSharding(mesh, P(axis))``.
    :func:`shard_rows` takes the same block without communication."""
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: Mesh):
    """DTensor placements of a replicated array: JAX's
    ``NamedSharding(mesh, P())``."""
    return [Replicate()] * mesh.ndim


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_TILES) -> torch.Tensor:
    """The rows of a global [N, ...] tensor that this rank owns along
    ``axis``: block ``axis_index`` of N / ranks rows (``ray_sharding``'s
    layout; in JAX, ``jax.device_put(x, ray_sharding(mesh, axis))`` hands
    each device this block). Every rank holds the same global tensor, so
    no data moves. Raises, as JAX does, when the ranks do not divide N."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks of axis {axis!r}")
    local = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * local:(i + 1) * local]


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_TILES) -> torch.Tensor:
    """The all-gather back of :func:`shard_rows`: the blocks of every rank
    along ``axis``, concatenated in axis order, on every rank. It stands in
    for reading a JAX array sharded by ``ray_sharding`` (or moving it to
    ``replicated``). Not differentiable. Under a profiler the call is a
    ``parallel.gather`` span."""
    with span("parallel.gather"):
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
        return torch.cat(parts)


def _slurm_first_host(nodelist: str) -> str:
    """The first host of a SLURM node list ("a", "a,b", "n[03-05,7],m")."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if m is None:
        raise ValueError(f"cannot parse SLURM node list {nodelist!r}")
    prefix, ranges = m.group(1), m.group(2)
    return prefix if ranges is None else prefix + re.split(r"[-,]", ranges)[0]


def init_distributed_if_needed(backend: str = "nccl", timeout_s: Optional[float] = None) -> None:
    """Multi-process bring-up, on the JAX package's rules
    (``parallel/mesh.py::init_distributed_if_needed``), from environment
    variables alone:

      - explicit (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
        LOCAL_RANK): initialise, and raise if that fails;
      - SLURM with more than one task: initialise from SLURM_PROCID,
        SLURM_NTASKS, SLURM_LOCALID, the first host of the node list and a
        port from the job id; only here may a failure warn and leave the
        run single-process;
      - otherwise, and on a second call, do nothing.

    ``backend`` is NCCL (the card; then ``torch.cuda.set_device(LOCAL_RANK)``
    first) unless the caller names gloo (the CPU, or several ranks on one
    card); there is no fallback from one to the other. ``timeout_s`` bounds
    the rendezvous and every later collective (torch's default when None).
    ``cli.main()`` calls this first."""
    if dist.is_initialized():
        return
    env = os.environ
    explicit = "MASTER_ADDR" in env
    slurm = "SLURM_JOB_ID" in env and int(env.get("SLURM_NTASKS", "1") or 1) > 1
    if not explicit and not slurm:
        return
    try:
        # The explicit variables win where both launchers set them.
        addr = env.get("MASTER_ADDR") or _slurm_first_host(
            env.get("SLURM_STEP_NODELIST") or env["SLURM_JOB_NODELIST"])
        port = int(env.get("MASTER_PORT") or 20000 + int(env["SLURM_JOB_ID"]) % 40000)
        world = int(env["WORLD_SIZE"] if "WORLD_SIZE" in env else env["SLURM_NTASKS"])
        rank = int(env["RANK"] if "RANK" in env else env["SLURM_PROCID"])
        if backend == "nccl":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0"))))
        host = f"[{addr}]" if ":" in addr else addr
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                                world_size=world, rank=rank, **kw)
    except Exception:
        if explicit:
            raise   # an explicit launch that fails must be loud
        warnings.warn("torch.distributed initialisation from the SLURM environment failed; "
                      "continuing single-process", RuntimeWarning, stacklevel=2)
