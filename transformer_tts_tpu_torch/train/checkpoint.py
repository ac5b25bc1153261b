"""Port checkpoints: a ``torch.save`` of the model's ``state_dict``.

``save_checkpoint(model, dir)`` writes ``dir/model.pt``;
``load_checkpoint(model, dir)`` reads it back into ``model`` on the
model's device. The training-time policy (periodic saves, pruning,
averaging) comes with the training slice.
"""

from __future__ import annotations

import os

import torch
from torch import nn

CHECKPOINT_NAME = "model.pt"


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
