"""Sequence parallelism: attention with the sequence split over the ranks
of a process group (the port of transformer_tts_tpu/parallel/sp.py:40-96).

Each rank holds T/n query rows and the same T/n key and value rows of a
(B, H, T, d) attention. ``sequence_parallel_attention`` all-gathers K and
V along T through a differentiable gather (its backward reduce-scatters
dK and dV back to their ranks), then runs the port's ``flash_attention``
op on the local T/n query rows against all T keys: K1 (K2 in the
backward) at T_q = T/n, T_k = T. Memory per rank: O(T/n) activations and
O(T) gathered K/V.

Non-causal only, as in the JAX package: the causal variant needs each
shard's global query offset inside the kernel.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_len: torch.Tensor,
                                group=None, *,
                                sm_scale: Optional[float] = None,
                                causal: bool = False) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V over the sequence split across ``group``.

    ``q``, ``k``, ``v``: this rank's (B, H, T/n, d) slices of the global
    (B, H, T, d) tensors, rank r holding rows [r T/n, (r + 1) T/n);
    ``k_len``: (B,) int32 valid key lengths of the global sequence, the
    same on every rank. Returns this rank's (B, H, T/n, d) rows of the
    output."""
    from torch.distributed.nn.functional import all_gather

    from transformer_tts_tpu_torch.ops.flash_attention import (
        flash_attention)
    if causal:
        raise NotImplementedError(
            "sequence_parallel_attention is non-causal only; the causal "
            "variant needs each shard's global query offset in the kernel")
    with warnings.catch_warnings():
        # deprecated in newer torch for _functional_collectives, whose
        # autograd older versions lack
        warnings.simplefilter("ignore", FutureWarning)
        k_full = torch.cat(all_gather(k.contiguous(), group=group), dim=2)
        v_full = torch.cat(all_gather(v.contiguous(), group=group), dim=2)
    out, _ = flash_attention(q.contiguous(), k_full, v_full, k_len,
                             sm_scale=sm_scale)
    return out
