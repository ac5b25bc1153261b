"""Learning-rate schedule, optimizer and initialisation of the train step
(the port of transformer_tts_tpu/train/schedule.py: ``noam_schedule``
:25-33, ``build_optimizer`` :177-208, ``apply_reference_init`` :211-240).

``build_optimizer`` returns an ``Optimizer`` that applies, on each call of
``step()``, what the JAX package's optax chain does:

* ``accum_grad`` > 1 (``optax.MultiSteps``): the running mean of k
  gradients; the inner optimizer, its count and the Noam lr advance only on
  every k-th call, and the parameters do not move in between;
* ``clip_by_global_norm(clip)``: gradients times clip / max(norm, clip);
* Adam (b1 0.9, b2 0.98, eps 1e-9) at the Noam lr for ``Noam``, or Adam /
  AdamW at a fixed lr with optax's defaults. The lr of the n-th update
  (n = 0, 1, ...) is ``noam(n)``, which evaluates the formula at n + 1, as
  optax reads the schedule at its count before incrementing it.

RAdam comes with the slice "parallelism and remaining tools".
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.fastspeech2 import later_slice


def noam_schedule(d_model: int, warmup_factor: float = 1.0,
                  warmup_step: int = 4000) -> Callable[[int], float]:
    """lr of update ``count`` (0-based): warmup_factor * d_model^-0.5 *
    min(s^-0.5, s * warmup_step^-1.5) with s = count + 1."""
    def schedule(count: int) -> float:
        s = float(count) + 1.0
        return (warmup_factor * d_model ** -0.5
                * min(s ** -0.5, s * warmup_step ** -1.5))
    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in fp32, as a tensor
    on the tensors' device (no sync)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class Optimizer:
    """MultiSteps -> clip -> inner torch optimizer (see the module doc).

    ``step()`` reads the parameters' ``.grad`` and returns their global norm
    before clipping, as a tensor on the device.
    """

    def __init__(self, params: Iterable[nn.Parameter],
                 inner: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]],
                 clip: Optional[float], accum_grad: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.inner = inner
        self.schedule = schedule
        self.clip = clip
        self.accum_grad = accum_grad
        self.count = 0          # inner updates so far
        self.mini_step = 0      # calls since the last inner update
        self.acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        # optax updates every parameter, a zero gradient included, where
        # torch's optimizers skip a parameter whose .grad is None
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = self._grads()
        norm = global_norm(grads)
        if self.accum_grad > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_grad:
                return norm
            self.mini_step = 0
            for g, a in zip(grads, self.acc):
                g.copy_(a)
                a.zero_()
        if self.clip is not None:
            update_norm = global_norm(grads) if self.accum_grad > 1 else norm
            factor = self.clip / torch.clamp(update_norm, min=self.clip)
            torch._foreach_mul_(grads, factor)
        if self.schedule is not None:
            for group in self.inner.param_groups:
                group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state["inner"])
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        self.acc = state["acc"]
        if self.acc is not None:
            self.acc = [a.to(p.device)
                        for a, p in zip(self.acc, self.params)]


def build_optimizer(params: Iterable[nn.Parameter], name: str,
                    d_model: int, warmup_factor: float = 1.0,
                    warmup_step: int = 4000, learning_rate: float = 1e-3,
                    clip: Optional[float] = 1.0,
                    accum_grad: int = 1) -> Optimizer:
    params = [p for p in params if p.requires_grad]
    name = name.lower()
    schedule = None
    if name == "noam":
        schedule = noam_schedule(d_model, warmup_factor, warmup_step)
        inner = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.98),
                                 eps=1e-9)
    elif name == "adam":
        inner = torch.optim.Adam(params, lr=learning_rate)
    elif name == "adamw":
        # optax.adamw's defaults: b2 0.999, eps 1e-8, weight decay 1e-4
        inner = torch.optim.AdamW(params, lr=learning_rate,
                                  weight_decay=1e-4)
    elif name == "radam":
        later_slice("the RAdam optimizer", "remaining tools")
    else:
        raise ValueError(f"unknown optimizer: {name}")
    return Optimizer(params, inner, schedule, clip, accum_grad)


@torch.no_grad()
def apply_reference_init(model: nn.Module,
                         generator: torch.Generator) -> None:
    """The reference's ``init_weight``: conv weights (rank >= 3) drawn
    Kaiming-normal, std sqrt(2 / fan_in), from ``generator``; every 1-D
    ``bias`` zeroed; Linear weights and the rest left alone."""
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.dim() >= 3:
            std = math.sqrt(2.0 / p[0].numel())
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        elif name.endswith("bias") and p.dim() == 1:
            p.zero_()
