"""Learning-rate schedule, optimizer and initialisation of the train step
(the port of transformer_tts_tpu/train/schedule.py: ``noam_schedule``
:25-33, ``reference_radam`` :49-110, ``build_optimizer`` :177-208,
``apply_reference_init`` :211-240).

``build_optimizer`` returns an ``Optimizer`` that applies, on each call of
``step()``, what the JAX package's optax chain does:

* ``accum_grad`` > 1 (``optax.MultiSteps``): the mean of k gradients,
  summed in ``.grad`` (``zero_grad`` leaves a partial sum there, so the
  next backward adds to it; under DDP the non-final micro-steps run under
  ``no_sync`` and the last backward all-reduces the sum) and divided by k
  at the update; the inner optimizer, its count and the Noam lr advance
  only on every k-th call, and the parameters do not move in between;
* ``clip_by_global_norm(clip)``: gradients times clip / max(norm, clip);
* Adam (b1 0.9, b2 0.98, eps 1e-9) at the Noam lr for ``Noam``, or Adam /
  AdamW at a fixed lr with optax's defaults. The lr of the n-th update
  (n = 0, 1, ...) is ``noam(n)``, which evaluates the formula at n + 1, as
  optax reads the schedule at its count before incrementing it;
* ``RAdam`` (``ReferenceRAdam``) at a fixed lr: the reference's vendored
  RAdam, as the JAX package's ``reference_radam`` has it.

``step()`` returns the global norm of the mean so far: with ``accum_grad``
> 1 that of the micro-steps' mean up to this one, where optax's
MultiSteps chain is handed the micro-step's own gradient (only the log
differs; at the update it is the norm that the clip reads). A checkpoint
taken mid-accumulation keeps the partial sum (``state_dict``'s
``acc``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn


def noam_schedule(d_model: int, warmup_factor: float = 1.0,
                  warmup_step: int = 4000) -> Callable[[int], float]:
    """lr of update ``count`` (0-based): warmup_factor * d_model^-0.5 *
    min(s^-0.5, s * warmup_step^-1.5) with s = count + 1."""
    def schedule(count: int) -> float:
        s = float(count) + 1.0
        return (warmup_factor * d_model ** -0.5
                * min(s ** -0.5, s * warmup_step ** -1.5))
    return schedule


def global_norm(tensors: List[torch.Tensor], split=None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in fp32, as a tensor
    on the tensors' device (no sync). Under tensor parallelism ``split``
    marks the tensors that are one rank's part of a parameter split over
    ``group`` (parallel/tp.py): their squares are summed over the group's
    ranks, the others' (the same on every rank) counted once, so the norm
    is the unsharded model's."""
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for t in tensors])
    if group is None:
        return torch.linalg.vector_norm(norms)
    import torch.distributed as dist
    mask = torch.tensor(split, device=norms.device)
    split_sum = (norms[mask] ** 2).sum()
    dist.all_reduce(split_sum, group=group)
    return torch.sqrt(split_sum + (norms[~mask] ** 2).sum())


class Optimizer:
    """MultiSteps -> clip -> inner torch optimizer (see the module doc).

    ``step()`` reads the parameters' ``.grad`` and returns the global norm
    of the mean so far before clipping, as a tensor on the device.
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
        # tensor parallelism (parallel/tp.shard_optimizer_state): the
        # model group and which parameters are split over it
        self.norm_group = None
        self.split = None

    @property
    def syncs(self) -> bool:
        """Whether the coming backward ends an accumulation (or there is
        none): the one whose gradients DDP all-reduces."""
        return self.mini_step == self.accum_grad - 1

    def zero_grad(self):
        if self.mini_step > 0:
            return              # the accumulation's partial sum stays
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
        self.mini_step += 1
        if self.mini_step < self.accum_grad:
            return self.norm(grads) / self.mini_step
        if self.accum_grad > 1:
            torch._foreach_div_(grads, float(self.accum_grad))
        self.mini_step = 0
        norm = self.norm(grads)
        if self.clip is not None:
            factor = self.clip / torch.clamp(norm, min=self.clip)
            torch._foreach_mul_(grads, factor)
        if self.schedule is not None:
            for group in self.inner.param_groups:
                group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1
        return norm

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads``, the unsharded model's under tensor
        parallelism."""
        return global_norm(grads, self.split, self.norm_group)

    def state_dict(self) -> dict:
        """The inner optimizer's state, the counts and, mid-accumulation,
        the partial sum of the gradients (``acc``)."""
        acc = ([g.detach().clone() for g in self._grads()]
               if self.mini_step else None)
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state["inner"])
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        if state["acc"] is not None:
            for p, a in zip(self.params, state["acc"]):
                p.grad = a.to(p.device, p.dtype).clone()


class ReferenceRAdam(torch.optim.Optimizer):
    """The reference's vendored RAdam (radam.py:5-93), as the JAX
    package's ``reference_radam`` has it, which differs from
    ``torch.optim.RAdam``: eps is added to sqrt(v) of the *uncorrected*
    second moment (the (1 - b2^t) correction is folded into the step
    size); below the rectification threshold N_sma >= 5 the update is
    momentum SGD m / (1 - b1^t), or none with ``degenerated_to_sgd=False``;
    weight decay ``lr * wd * p`` joins the update only when a step is
    taken. The step's scalars are computed in fp32, as JAX's are."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 degenerated_to_sgd: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      degenerated_to_sgd=degenerated_to_sgd))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                g = p.grad
                m = b1 * state["exp_avg"] + (1 - b1) * g
                v = b2 * state["exp_avg_sq"] + (1 - b2) * g * g
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)
                t = torch.tensor(float(state["step"]), dtype=f32)
                beta2_t = torch.pow(torch.tensor(b2, dtype=f32), t)
                bias1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32), t)
                n_max = 2.0 / (1.0 - b2) - 1.0
                n_sma = n_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
                use_rect = bool(n_sma >= 5.0)
                if use_rect:
                    rect = torch.sqrt(
                        (1.0 - beta2_t) * (n_sma - 4.0) / (n_max - 4.0)
                        * (n_sma - 2.0) / n_sma * n_max / (n_max - 2.0)
                    ) / bias1
                    update = rect.to(p.device) * m / (
                        torch.sqrt(v) + group["eps"])
                elif group["degenerated_to_sgd"]:
                    update = m / bias1.to(p.device)
                else:
                    continue
                if group["weight_decay"] != 0.0:
                    update = update + group["weight_decay"] * p
                p.add_(-group["lr"] * update)
        return None


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
        # the reference's vendored RAdam, not torch's (see ReferenceRAdam)
        inner = ReferenceRAdam(params, lr=learning_rate)
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
