"""Weight-only int8 (the port of transformer_tts_tpu/infer/quantize.py:
``quantize_tree`` :68-90, ``dequantize_tree``, ``quantization_stats``,
``has_quantized_leaves``), on a model's parameters.

The numbers are the JAX package's: for each eligible flax leaf ``w`` (float,
rank >= 2, at least ``min_size`` elements) the scale is ``s = max(amax,
1e-12) / 127``, ``amax`` the largest ``|w|`` over every axis of the leaf but
its last, and ``q = clip(round(w / s), -127, 127)`` as int8 (``torch.round``
rounds half to even, as ``jnp.round`` does). Flax and the port lay that last
axis out differently (a Linear's weight is the kernel transposed, a
ConvTranspose1d keeps its output channels in dim 1, an embedding table its
features in dim 1, and a GRU weight stacks three flax gate leaves as row
blocks), so each parameter's axis and its leaves come from the map that
``compat/from_jax`` writes the weights by (``flax_layouts``,
``vocoder_flax_layouts``); eligibility is decided per flax leaf. Buffers
(BatchNorm running statistics) are never quantized, as JAX leaves
``batch_stats`` alone.

A quantized entry is ``{"q": int8 (the tensor's shape), "s": fp32 (its
shape with 1 in every dim but the scale's)}``; every other entry passes
through. In the port the served weights are ``q * s`` written into the
model's own fp32 parameters (``quantize_parameters_``): the attention
kernels, cuBLAS and cuDNN read float weights, and the graphed AR decode
reads them (or ``DecodeWeights``' bf16 copies of them) at fixed addresses.
So the outputs are those of int8 weights, as JAX's, but the card holds no
fewer weight bytes: ``quantization_stats``' ``bytes_q`` is what a stored
int8 copy takes, not what the model holds.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from transformer_tts_tpu_torch.compat.from_jax import QLeaf


def is_quantized(entry) -> bool:
    return (isinstance(entry, dict) and set(entry) == {"q", "s"}
            and entry["q"].dtype == torch.int8)


def has_quantized(state: Mapping) -> bool:
    return any(is_quantized(v) for v in state.values())


def _eligible(w: torch.Tensor, leaves: List[QLeaf], min_size: int) -> bool:
    """JAX's rule, per flax leaf; the leaves of one tensor must agree."""
    votes = {leaf.ndim >= 2 and w.numel() // leaf.blocks >= min_size
             for leaf in leaves}
    if len(votes) != 1:
        raise ValueError("the flax leaves of one tensor disagree on int8")
    return w.is_floating_point() and votes.pop()


def quantize_state_dict(state: Mapping[str, torch.Tensor],
                        layouts: Mapping[str, List[QLeaf]], *,
                        min_size: int = 4096) -> Dict:
    """``state`` with each eligible parameter of ``layouts`` replaced by
    ``{"q", "s"}``; the rest, buffers included, pass through."""
    out = dict(state)
    for name, leaves in layouts.items():
        w = state[name]
        if not _eligible(w, leaves, min_size):
            continue
        axis = leaves[0].axis % w.ndim
        wf = w.float()
        amax = wf.abs().amax(dim=[d for d in range(w.ndim) if d != axis],
                             keepdim=True)
        s = amax.clamp(min=1e-12) / 127.0
        q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
        out[name] = {"q": q, "s": s}
    return out


def dequantize_state_dict(state: Mapping, dtype=torch.float32) -> Dict:
    return {k: (v["q"].float() * v["s"]).to(dtype) if is_quantized(v) else v
            for k, v in state.items()}


def quantization_stats(state: Mapping[str, torch.Tensor], qstate: Mapping,
                       layouts: Mapping[str, List[QLeaf]]) -> Dict:
    """JAX's accounting, per flax leaf: fp bytes at the leaf's dtype, int8
    bytes as q plus its fp32 scales; a passthrough leaf counts the same in
    both (a GRU's ``bias_hh`` holds one leaf, its n gate's)."""
    stats = {"n_quantized": 0, "n_passthrough": 0, "bytes_fp": 0,
             "bytes_q": 0}
    for name, leaves in layouts.items():
        w = state[name]
        for leaf in leaves:
            size = w.numel() // leaf.blocks
            stats["bytes_fp"] += size * w.element_size()
            if is_quantized(qstate[name]):
                stats["n_quantized"] += 1
                stats["bytes_q"] += (size + qstate[name]["s"].numel()
                                     // leaf.blocks * 4)
            else:
                stats["n_passthrough"] += 1
                stats["bytes_q"] += size * w.element_size()
    stats["compression"] = (stats["bytes_fp"] / stats["bytes_q"]
                            if stats["bytes_q"] else 1.0)
    return stats


@torch.no_grad()
def quantize_parameters_(model: nn.Module,
                         layouts: Mapping[str, List[QLeaf]], *,
                         min_size: int = 4096) -> Dict:
    """Quantize ``model``'s parameters and write each ``q * s`` back into
    its parameter in place (a ``copy_``, which bumps the tensor's
    ``_version``, so ``DecodeWeights`` re-copies from it); returns the
    stats."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    qstate = quantize_state_dict(params, layouts, min_size=min_size)
    for name, w in dequantize_state_dict(qstate).items():
        if is_quantized(qstate[name]):
            params[name].copy_(w)
    return quantization_stats(params, qstate, layouts)
