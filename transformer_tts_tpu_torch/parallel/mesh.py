"""The process-group layer of data- and tensor-parallel training (the port
of transformer_tts_tpu/parallel/mesh.py, on ``torch.distributed``).

The JAX package shards each global batch over a ``data`` mesh and lets
pjit insert the gradient all-reduce; here every rank is one process with
one card, the model is wrapped in ``DistributedDataParallel`` and the
all-reduce is DDP's (NCCL on the card; gloo only when the caller asks for
the CPU, never as a fallback):

* ``init_distributed`` joins the group: explicit (coordinator, number of
  processes, process id) or torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
* ``data_parallel`` wraps a model in DDP over the data-parallel group
  (default: every rank), whose constructor broadcasts the group's first
  rank's parameters and buffers (JAX's ``replicate_global`` :110-128:
  every process built the same state from one seed; the broadcast makes
  that so), and gives every flax-style BatchNorm a group of the same
  ranks, so its train-mode statistics are the global batch's as pjit
  gives them to flax (ops/feedforward.py);
* ``check_local_batch`` is ``make_global_batch``'s (:88-107) contract:
  every rank's local arrays have the same shapes (the loader's
  ``fixed_shapes``).

* ``make_mesh`` (:31-42) lays the ranks out as a ``DeviceMesh`` of dims
  (``data``, ``model``), data-major: rank = d * model + m. The ``model``
  dim is tensor parallelism's (parallel/tp.py): the ranks of one
  ``model`` group hold the same rows and split the heads and FFN
  channels; the ``data`` groups (one per ``model`` coordinate, so each
  holds one shard of every split weight) average the gradients;
* ``make_multislice_mesh`` (:53-79) adds an outer ``dcn`` dim (slices,
  joined by the slower network): dims (``dcn``, ``data``, ``model``),
  slice-major. Its data-parallel group is (``dcn``, ``data``), and
  ``hierarchical_hook`` makes DDP's all-reduce JAX's "whole design": a
  reduce-scatter over ``data``, an all-reduce of the 1/data shard over
  ``dcn``, an all-gather over ``data``;
* ``batch_rows`` gives a rank its rows of a global batch: those of its
  (``dcn``, ``data``) coordinate (``batch_sharding`` :45-50), the same
  on every rank of a ``model`` group.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``
    default to torchrun's ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. With ``device="cuda"`` the backend is NCCL and the rank's
    card is ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the rank modulo
    the cards of the host); ``device="cpu"`` takes gloo. A failure to
    start NCCL raises: nothing falls back to gloo."""
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("give --coordinator host:port, or run under "
                             "torchrun (MASTER_ADDR and MASTER_PORT)")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("data parallelism on the card, but torch "
                               "finds no CUDA device (pass --device cpu)")
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return dev


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def set_norm_group(model: nn.Module, group) -> int:
    """Give every flax-style BatchNorm and EMA VQ codebook of ``model``
    the group over which its train-mode statistics are reduced (None:
    this process's batch); returns how many there are."""
    from transformer_tts_tpu_torch.models.postnets import Quantize
    from transformer_tts_tpu_torch.ops.feedforward import FLAX_NORMS
    n = 0
    for m in model.modules():
        if isinstance(m, FLAX_NORMS + (Quantize,)):
            m.stats_group = group
            n += 1
    return n


def data_parallel(model: nn.Module, device=None, mesh=None
                  ) -> nn.parallel.DistributedDataParallel:
    """``model`` wrapped in DDP over the data-parallel group (every rank,
    or ``mesh``'s ``data_group``): the group's first rank's parameters and
    buffers broadcast to its other ranks, gradients averaged in the
    backward (on a multislice mesh through ``hierarchical_hook``), and its
    BatchNorms' and VQ codebooks' statistics reduced over a group of the
    same ranks (its own, so its collectives never interleave with DDP's
    buckets). Every family's train step gives every parameter a gradient,
    so DDP searches for no unused one. The wrapper's ``state_dict`` is
    not saved: checkpoints hold the bare model's (``TrainState.model``),
    whose keys carry no prefix."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel needs init_distributed first")
    if mesh is None:
        group, stats = None, dist.new_group()
    else:
        group, stats = data_group(mesh), data_group(mesh, own=True)
    set_norm_group(model, stats)
    dev = torch.device(device) if device is not None else next(
        model.parameters()).device
    first = 0 if group is None else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for buf in model.buffers():     # DDP broadcasts the parameters
            dist.broadcast(buf, first, group=group)
    with warnings.catch_warnings():
        # newer torch renames broadcast_buffers; the buffers were
        # broadcast above and move alike on every rank after that
        warnings.simplefilter("ignore", FutureWarning)
        ddp = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False, process_group=group)
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        ddp.comm_state = HierarchicalState(mesh)
        ddp.register_comm_hook(ddp.comm_state, hierarchical_hook)
    return ddp


# ---- meshes -----------------------------------------------------------------

def make_mesh(data: Optional[int] = None, model: int = 1, *,
              device="cuda"):
    """A ``DeviceMesh`` of dims (``data``, ``model``) over every rank,
    data-major (JAX ``make_mesh``); ``data`` defaults to the world size
    over ``model``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = process_count()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_multislice_mesh(n_slices: int, model: int = 1, *, device="cuda"):
    """A ``DeviceMesh`` of dims (``dcn``, ``data``, ``model``) over every
    rank, slice-major (JAX ``make_multislice_mesh``): the ranks of a slice
    are consecutive, ``data`` = world / (n_slices * model)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = process_count()
    if n % (n_slices * model):
        raise ValueError(f"{n} ranks not divisible by {n_slices} slices x "
                         f"model={model}")
    return init_device_mesh(
        torch.device(device).type,
        (n_slices, n // (n_slices * model), model),
        mesh_dim_names=("dcn", "data", "model"))


def data_group(mesh, own: bool = False):
    """This rank's data-parallel group of ``mesh``: the ranks of its
    ``model`` coordinate, over (``dcn``,) ``data``. Every rank creates
    every such group, in one order (``new_group`` is collective), once
    per mesh (kept on the mesh); ``own`` gives a second group of the same
    ranks (the statistics' own)."""
    groups = mesh.__dict__.setdefault("data_groups", {})
    if own not in groups:
        layout = mesh.mesh.reshape(-1, mesh.size(
            mesh.mesh_dim_names.index("model"))).T.tolist()
        for ranks in layout:
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                groups[own] = group
    return groups[own]


def data_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's index among the data-parallel coordinates, their
    number): (dcn, data) flattened slice-major."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for dim in mesh.mesh_dim_names[:-1]:         # (dcn,) data
        size = mesh.size(mesh.mesh_dim_names.index(dim))
        index, count = index * size + coord[dim], count * size
    return index, count


def batch_rows(mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank holds:
    its data coordinate's equal part (``batch_sharding``)."""
    index, count = data_coordinate(mesh)
    if batch_size % count:
        raise ValueError(f"a batch of {batch_size} rows does not split "
                         f"over {count} data-parallel ranks")
    part = batch_size // count
    return slice(index * part, (index + 1) * part)


class HierarchicalState:
    """``hierarchical_hook``'s groups and its counts: the buckets DDP
    handed it, their gradient elements (``elements``) and the elements the
    ``dcn`` all-reduce carried (``dcn_elements``). DDP keeps it as
    ``comm_state``."""

    def __init__(self, mesh):
        self.data = mesh.get_group("data")
        self.dcn = mesh.get_group("dcn")
        self.data_size = dist.get_world_size(self.data)
        self.world = self.data_size * dist.get_world_size(self.dcn)
        self.buckets = 0
        self.elements = 0
        self.dcn_elements = 0


def hierarchical_hook(state: HierarchicalState, bucket):
    """DDP's all-reduce of a gradient bucket as JAX's multislice mesh
    decomposes it: a reduce-scatter over ``data`` (within a slice), an
    all-reduce of this rank's 1/data shard over ``dcn`` (across slices:
    the slow network carries the reduced shard only), an all-gather over
    ``data``; then the mean over every data-parallel rank."""
    flat = bucket.buffer()
    n = flat.numel()
    part = -(-n // state.data_size)
    padded = torch.zeros(part * state.data_size, dtype=flat.dtype,
                         device=flat.device)
    padded[:n] = flat
    shard = torch.empty(part, dtype=flat.dtype, device=flat.device)
    dist.reduce_scatter_tensor(shard, padded, group=state.data)
    dist.all_reduce(shard, group=state.dcn)
    dist.all_gather_into_tensor(padded, shard, group=state.data)
    state.buckets += 1
    state.elements += n
    state.dcn_elements += part
    flat.copy_(padded[:n]).div_(state.world)
    fut = torch.futures.Future()
    fut.set_result(flat)
    return fut


def check_local_batch(batch: Dict) -> None:
    """Raise unless every rank's local arrays have the same shapes (one
    all-gather of their shapes)."""
    shapes = sorted((k, tuple(np.shape(v))) for k, v in batch.items()
                    if isinstance(v, (np.ndarray, torch.Tensor))
                    and np.ndim(v) > 0)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, shapes)
    if any(s != shapes for s in everyone):
        raise ValueError(
            "the ranks' local batches differ in shape (the loader's "
            f"fixed_shapes pads them to one): {everyone}")
