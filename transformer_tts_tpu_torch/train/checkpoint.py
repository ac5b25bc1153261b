"""Port checkpoints (the port of transformer_tts_tpu/train/checkpoint.py:
``list_epochs``, ``should_save`` :36-62, ``save_checkpoint`` and
``restore_checkpoint`` :87-155, ``prune_checkpoints`` and
``average_checkpoints`` :252-316, in torch's format).

``save_checkpoint(model, dir)`` writes ``dir/model.pt`` (a ``torch.save``
of the ``state_dict``, on the CPU) and ``load_checkpoint(model, dir)``
reads it back onto the model's device; the synthesis CLI loads that file.

Training saves one directory per epoch, ``save_dir/epoch_N/``, holding
``model.pt``, the ``hparams.py`` snapshot beside it (so the directory is a
synthesis ``--load_name``) and ``train_state.pt``: the step, the epoch, the
generator's state and, when ``with_optimizer``, the optimizer's state.
``restore_train_checkpoint`` resumes from one; an epoch saved without the
optimizer keeps the fresh one, as in the JAX package. Under data
parallelism rank 0 alone writes (the ranks hold the same weights), and
every rank waits at a ``barrier`` before a resume reads, so none reads a
checkpoint that is still being written (the JAX CLI's :296-307). An
optimizer saved mid-accumulation keeps the partial sum of the gradients;
under data parallelism that is the ranks' mean (``share_partial_sums``),
so a resume goes on as the uninterrupted run would. Under tensor
parallelism (``state.model_group``, parallel/tp.py) every rank takes part
in gathering the split weights and moments, and global rank 0 writes them
whole, under the unsharded names and shapes: the checkpoint an unsharded
run writes. A resume into a split state loads each rank's parts.
``resolve_checkpoint`` picks the directory a synthesis ``--load_name``
(with ``--epoch``) names, as the JAX package's ``_resolve_path``.

``average_checkpoints`` averages the saved ``state_dict``s of a range of
epochs, as the reference's average_checkpoints.py averages every
``state_dict`` key: each floating tensor (parameters and BatchNorm running
statistics) as the float64 mean, cast back to its dtype, each integer
buffer (``num_batches_tracked``) taken from the newest epoch. It writes
``save_dir/average_epoch{a}-epoch{b}/`` with ``model.pt`` and an
``hparams.py``, a synthesis ``--load_name`` (cli/average_checkpoints.py).
``prune_checkpoints`` deletes the epochs the reference's retention rule
would not have written, as the JAX package's.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

import torch
from torch import nn

CHECKPOINT_NAME = "model.pt"
TRAIN_STATE_NAME = "train_state.pt"
_EPOCH_RE = re.compile(r"^epoch_(\d+)$")


def save_checkpoint(model: nn.Module, save_dir: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, CHECKPOINT_NAME)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, path)
    return path


def load_checkpoint(model: nn.Module, load_dir: str) -> nn.Module:
    path = os.path.join(load_dir, CHECKPOINT_NAME)
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state)
    return model


def epoch_dir(save_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_dir), f"epoch_{epoch}")


def list_epochs(save_dir: str) -> List[int]:
    if not os.path.isdir(save_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_EPOCH_RE.match,
                                               os.listdir(save_dir)) if m)


def resolve_checkpoint(path_or_dir: str,
                       epoch: Optional[int] = None) -> str:
    """The checkpoint directory a synthesis ``--load_name`` names (the JAX
    package's ``_resolve_path``): with ``epoch``, or for a directory whose
    name is not ``epoch_N``/``average_N``, its ``epoch_<epoch>`` (default
    the newest) when it holds any; else the directory itself."""
    name = os.path.basename(os.path.normpath(path_or_dir))
    if epoch is not None or not name.startswith(("epoch_", "average_")):
        epochs = list_epochs(path_or_dir)
        if epochs:
            return epoch_dir(path_or_dir,
                             epoch if epoch is not None else epochs[-1])
    return path_or_dir


def should_save(epoch: int, max_epoch: int, save_per_epoch: int) -> bool:
    """The reference's retention rule for 1-based ``epoch``: the last 10
    epochs, and a 10-epoch window up to every multiple of
    ``save_per_epoch``."""
    if epoch >= max_epoch - 10:
        return True
    m = epoch % save_per_epoch
    return m >= save_per_epoch - 10 or m == 0


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the default group (none outside one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def share_partial_sums(optimizer, group=None) -> None:
    """Mid-accumulation under DDP each rank's ``.grad`` holds its own
    partial sum (those micro-steps ran under ``no_sync``): replace it on
    every rank by the mean over the ranks, which rank 0 then saves.
    Training goes on as it would have: the last micro-step's all-reduce
    averages the sums, and the average is linear."""
    import torch.distributed as dist
    if not optimizer.mini_step:
        return
    world = dist.get_world_size(group)
    for p in optimizer.params:     # step() gave each a .grad
        dist.all_reduce(p.grad, group=group)
        p.grad.div_(world)


def save_train_checkpoint(save_dir: str, state, epoch: int, hp, *,
                          with_optimizer: bool = True) -> str:
    """Save a ``TrainState`` as ``save_dir/epoch_<epoch>/`` (on rank 0
    alone under data parallelism; the other ranks only return the
    path)."""
    from transformer_tts_tpu_torch.parallel import tp
    path = epoch_dir(save_dir, epoch)
    if with_optimizer and state.ddp is not None:
        share_partial_sums(state.optimizer, state.data_group)
    group = state.model_group
    if group is not None:       # every rank gathers; rank 0 writes
        weights = tp.gather_state_dict(state.model, group)
        optimizer = (tp.gather_optimizer_state(state.optimizer, group)
                     if with_optimizer else None)
    if not is_writer():
        return path
    if group is None:
        save_checkpoint(state.model, path)
    else:
        os.makedirs(path, exist_ok=True)
        torch.save({k: v.cpu() for k, v in weights.items()},
                   os.path.join(path, CHECKPOINT_NAME))
    hp.snapshot(path)
    payload = {"step": state.step, "epoch": epoch,
               "generator": state.generator.get_state()}
    if with_optimizer:
        payload["optimizer"] = (state.optimizer.state_dict()
                                if group is None else optimizer)
    torch.save(payload, os.path.join(path, TRAIN_STATE_NAME))
    return path


def restore_train_checkpoint(save_dir: str, state,
                             epoch: Optional[int] = None) -> Tuple[object,
                                                                   int]:
    """Load ``epoch`` (default: the newest) into ``state``; returns
    (state, epoch). Every rank waits at ``barrier`` first."""
    barrier()
    epochs = list_epochs(save_dir)
    if not epochs:
        raise FileNotFoundError(f"no checkpoints under {save_dir}")
    epoch = epoch if epoch is not None else epochs[-1]
    path = epoch_dir(save_dir, epoch)
    group = state.model_group
    if group is None:
        load_checkpoint(state.model, path)
    else:
        from transformer_tts_tpu_torch.parallel import tp
        device = next(state.model.parameters()).device
        tp.load_full_state(state.model, torch.load(
            os.path.join(path, CHECKPOINT_NAME), map_location=device,
            weights_only=True), group)
    payload = torch.load(os.path.join(path, TRAIN_STATE_NAME),
                         map_location="cpu", weights_only=False)
    state.step = payload["step"]
    state.generator.set_state(payload["generator"])
    if "optimizer" in payload:
        state.optimizer.load_state_dict(payload["optimizer"])
        if group is not None:
            tp.shard_optimizer_state(state.optimizer, group)
    return state, payload["epoch"]


def prune_checkpoints(save_dir: str, current_epoch: int, max_epoch: int,
                      save_per_epoch: int) -> None:
    """Delete every saved epoch but ``current_epoch``, the two before it
    and those ``should_save`` keeps."""
    for e in list_epochs(save_dir):
        if e == current_epoch:
            continue
        if not (should_save(e, max_epoch, save_per_epoch)
                or e > current_epoch - 2):
            shutil.rmtree(epoch_dir(save_dir, e), ignore_errors=True)


def average_checkpoints(save_dir: str, start_epoch: int, end_epoch: int, *,
                        hp_file: Optional[str] = None):
    """Average the ``state_dict``s of the saved epochs in [start_epoch,
    end_epoch] into ``save_dir/average_epoch{start}-epoch{end}/``: its
    ``model.pt`` and a copy of ``hp_file`` (default:
    the newest epoch's ``hparams.py``, else ``save_dir``'s) as
    ``hparams.py``. Returns (the averaged ``state_dict``, the directory).
    """
    epochs = [e for e in list_epochs(save_dir)
              if start_epoch <= e <= end_epoch]
    if not epochs:
        raise FileNotFoundError(
            f"no checkpoints in [{start_epoch}, {end_epoch}] under "
            f"{save_dir}")
    sums, newest = {}, None
    for e in epochs:
        newest = torch.load(os.path.join(epoch_dir(save_dir, e),
                                         CHECKPOINT_NAME),
                            map_location="cpu", weights_only=True)
        for key, value in newest.items():
            if value.is_floating_point():
                sums[key] = sums.get(key, 0.0) + value.double()
    avg = {key: (sums[key] / len(epochs)).to(value.dtype)
           if value.is_floating_point() else value.clone()
           for key, value in newest.items()}
    out_path = os.path.join(os.path.abspath(save_dir),
                            f"average_epoch{start_epoch}-epoch{end_epoch}")
    if os.path.exists(out_path):
        shutil.rmtree(out_path)
    os.makedirs(out_path)
    torch.save(avg, os.path.join(out_path, CHECKPOINT_NAME))
    if hp_file is None:
        hp_file = os.path.join(epoch_dir(save_dir, epochs[-1]), "hparams.py")
        if not os.path.exists(hp_file):
            hp_file = os.path.join(save_dir, "hparams.py")
    if os.path.exists(hp_file):
        shutil.copyfile(hp_file, os.path.join(out_path, "hparams.py"))
    return avg, out_path
