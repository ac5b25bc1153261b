"""The process-group layer of data-parallel training (the port of
transformer_tts_tpu/parallel/mesh.py:28-128, on ``torch.distributed``).

The JAX package shards each global batch over a ``data`` mesh and lets
pjit insert the gradient all-reduce; here every rank is one process with
one card, the model is wrapped in ``DistributedDataParallel`` and the
all-reduce is DDP's (NCCL on the card; gloo only when the caller asks for
the CPU, never as a fallback):

* ``init_distributed`` joins the group: explicit (coordinator, number of
  processes, process id) or torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
* ``data_parallel`` wraps a model in DDP, whose constructor broadcasts
  rank 0's parameters and buffers (JAX's ``replicate_global`` :110-128:
  every process built the same state from one seed; the broadcast makes
  that so), and gives every flax-style BatchNorm the group, so its train-
  mode statistics are the global batch's as pjit gives them to flax
  (ops/feedforward.py);
* ``check_local_batch`` is ``make_global_batch``'s (:88-107) contract:
  every rank's local arrays have the same shapes (the loader's
  ``fixed_shapes``).

``make_mesh``'s ``model`` axis is tensor parallelism's, a later slice.
``make_multislice_mesh`` (:52-79) has no counterpart: across nodes NCCL
picks its own hierarchical all-reduce (ring or tree over NVLink within a
node and the network between nodes).
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, Optional

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


def data_parallel(model: nn.Module,
                  device=None) -> nn.parallel.DistributedDataParallel:
    """``model`` wrapped in DDP over the default group: rank 0's
    parameters and buffers broadcast to every rank, gradients averaged in
    the backward, and its BatchNorms' and VQ codebooks' statistics
    reduced over a group of the same ranks (its own, so its collectives never interleave with
    DDP's buckets). Every family's train step gives every parameter a
    gradient, so DDP searches for no unused one. The wrapper's
    ``state_dict`` is not saved: checkpoints hold the bare model's
    (``TrainState.model``), whose keys carry no prefix."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel needs init_distributed first")
    set_norm_group(model, dist.new_group())
    dev = torch.device(device) if device is not None else next(
        model.parameters()).device
    with torch.no_grad():
        for buf in model.buffers():     # DDP broadcasts the parameters
            dist.broadcast(buf, 0)
    with warnings.catch_warnings():
        # newer torch renames broadcast_buffers; the buffers were
        # broadcast above and move alike on every rank after that
        warnings.simplefilter("ignore", FutureWarning)
        return nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)


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
