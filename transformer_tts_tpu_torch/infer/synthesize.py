"""Synthesis (the port of ``denormalize``, ``sample_perturbation``,
``synthesize_fastspeech2`` and the AR decode of ``_ar_check``, ``_ar_init``,
``_ar_body`` and ``synthesize_transformer_tts``,
transformer_tts_tpu/infer/synthesize.py:39-87 and :186-301).

FastSpeech 2: one non-autoregressive forward in eval mode; the optional
pitch/duration perturbation factors come from {0.8, 0.9, 1.0, 1.1, 1.2};
the mel is de-normalized as ``mel * sqrt(var) + mean`` on the device.

AR Transformer-TTS: the KV-cached decode loop (see
``synthesize_transformer_tts``); the cache keeps every attention of the
loop on the masked path, so it launches no kernel. Every decode step
writes its carry in place (fixed addresses), so on a CUDA device the loop
runs as a CUDA graph of ``DONE_CHECK_EVERY`` steps, captured once per
(model, batch size, text length, ``max_steps``, dtype, stop threshold)
and replayed, the counterpart of the JAX package's compiled
``while_loop``; the eager loop (``ar_decode``) is what the graph captures,
runs on the CPU, and is the graph's reference on the card. Under bf16
amp the graph reads bf16 copies of the step's matmul and conv weights
(``DecodeWeights``), so it replays no cast of them at every step.
"""

from __future__ import annotations

import random
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from transformer_tts_tpu_torch.models.fastspeech2 import FastSpeech2
from transformer_tts_tpu_torch.models.transformer_tts import TransformerTTS
from transformer_tts_tpu_torch.ops.masks import pad_mask

PERTURBATION_CHOICES = (0.8, 0.9, 1.0, 1.1, 1.2)
MAX_AR_STEPS = 500          # decode steps (frame groups) per utterance
DONE_CHECK_EVERY = 8        # decode steps between the host's stop checks


def sample_perturbation(rng: Optional[random.Random] = None) -> float:
    r = rng or random
    return r.choice(PERTURBATION_CHOICES)


def denormalize(mel: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor) -> torch.Tensor:
    return mel * torch.sqrt(var) + mean


@torch.inference_mode()
def synthesize_fastspeech2(
    model: FastSpeech2, text: torch.Tensor, pos_text: torch.Tensor,
    max_frames: int, mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None, *, pitch_scale: float = 1.0,
    duration_scale: float = 1.0, use_prenet: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward; returns (mel (B, T, mel), mel_len (B,), durations (B, L)).

    ``durations`` are the unscaled predictions, 0 on padded phones, as
    the JAX function returns them.
    """
    model.eval()
    src_mask = pad_mask(pos_text)
    out = model(text, src_mask, max_frames, pitch_scale=pitch_scale,
                duration_scale=duration_scale)
    mel = out.mel_pre if use_prenet or out.mel_post is None else out.mel_post
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    durations = torch.round(
        torch.exp(out.log_duration.float()) - model.log_offset).clamp(min=0)
    durations = torch.where(src_mask[:, 0, :], durations,
                            torch.zeros_like(durations))
    return mel, out.mel_len, durations.to(torch.int32)


def _ar_check(model: TransformerTTS) -> None:
    """The incremental decode is causal only with a 1-wide decoder FFN
    (its conv is SAME-padded)."""
    if model.ff_conv_kernel_size_decoder != 1:
        raise ValueError(
            "incremental decode requires ff_conv_kernel_size_decoder == 1 "
            "(the decoder conv-FFN is SAME-padded and only causal at k=1)")


def _ar_init(model: TransformerTTS, b: int, max_steps: int,
             device) -> Dict[str, object]:
    """The decode loop's carry: the step (a device scalar), the input
    frame, per-layer (k, v) caches (B, H, max_steps, d_k) in the
    projections' dtype, the fp32 frame groups, ``done`` and ``length``."""
    heads = model.n_head_decoder
    d_k = model.d_model_decoder // heads
    dtype = model.cache_dtype
    caches = tuple(
        tuple(torch.zeros(b, heads, max_steps, d_k, dtype=dtype,
                          device=device) for _ in range(2))
        for _ in range(model.n_layer_decoder))
    return dict(
        step=torch.zeros((), dtype=torch.long, device=device),
        prev=torch.zeros(b, 1, model.mel_dim, dtype=dtype, device=device),
        caches=caches,
        groups=torch.zeros(b, max_steps, model.mel_dim * model.reduction_rate,
                           device=device),
        done=torch.zeros(b, dtype=torch.bool, device=device),
        length=torch.full((b,), max_steps, dtype=torch.long, device=device))


def _ar_reset(carry: Dict[str, object], max_steps: int) -> None:
    """Put a carry back to ``_ar_init``'s values, in place."""
    for tensor in (carry["step"], carry["prev"], carry["groups"],
                   carry["done"]):
        tensor.zero_()
    for kv in carry["caches"]:
        for cache in kv:
            cache.zero_()
    carry["length"].fill_(max_steps)


def _ar_body(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
             stop_threshold: float):
    """One decode step on the carry, in place: the group at ``step``, the
    stop rule (the mean of the r stop probabilities above
    ``stop_threshold``; ``length`` is set at a row's first stop), and the
    next input, the first frame of the predicted group. Every update
    writes into the carry's own tensors, so a captured step reads and
    writes fixed addresses."""
    mel_dim = model.mel_dim

    def body(c):
        step = c["step"]
        group, stop = model.decode_step(c["prev"], e_outputs, src_mask,
                                        c["caches"], step, cross_kvs)
        c["groups"].index_copy_(1, step.reshape(1), group.float())
        p_stop = torch.sigmoid(stop.float())[:, 0]            # (B, r)
        stop_now = p_stop.mean(dim=-1) > stop_threshold
        newly_done = stop_now & ~c["done"]
        c["length"].copy_(torch.where(newly_done, step + 1, c["length"]))
        c["done"].logical_or_(stop_now)
        c["prev"].copy_(group[:, :, :mel_dim])
        step.add_(1)
        return c

    return body


def _run_blocks(run_block: Callable[[int], None], done: torch.Tensor,
                max_steps: int) -> None:
    """``max_steps`` decode steps as blocks of ``DONE_CHECK_EVERY`` (the
    last one shorter when the block does not divide ``max_steps``), the
    host reading ``done`` before every block but the first and stopping
    once every row is done."""
    for first in range(0, max_steps, DONE_CHECK_EVERY):
        if first and bool(done.all()):
            break
        run_block(min(DONE_CHECK_EVERY, max_steps - first))


def ar_decode(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
              max_steps: int, stop_threshold: float) -> Dict[str, object]:
    """The eager decode loop: a fresh carry, then ``_ar_body`` step by step
    under ``_run_blocks``. Returns the carry (``groups``, ``length``)."""
    carry = _ar_init(model, e_outputs.shape[0], max_steps, e_outputs.device)
    body = _ar_body(model, e_outputs, src_mask, cross_kvs, stop_threshold)

    def run_block(n):
        for _ in range(n):
            body(carry)

    _run_blocks(run_block, carry["done"], max_steps)
    return carry


class DecodeWeights:
    """bf16 copies of the weights and biases of every ``nn.Linear`` and
    ``nn.Conv1d`` that ``decode_step`` runs (the decoder, ``out``,
    ``stop_token``), for a bf16-amp model: with them swapped in, autocast
    finds those operands in bf16 already and casts nothing, where it would
    otherwise cast each fp32 weight at every step. The copies round as
    autocast does (``Tensor.to``), so the results are the same bits.
    LayerNorm's parameters stay fp32, as autocast runs LayerNorm in fp32.

    ``refresh`` re-copies, into the same tensors (a captured graph keeps
    their addresses), when a parameter changed since the last copy: a new
    tensor in its place, or an in-place write (its ``_version``)."""

    def __init__(self, model: TransformerTTS):
        self.slots: List[Tuple[nn.Module, str, torch.Tensor]] = []
        if model.amp:
            for part in (model.decoder, model.out, model.stop_token):
                for mod in part.modules():
                    if isinstance(mod, (nn.Linear, nn.Conv1d)):
                        self.slots += [
                            (mod, name, p.detach().to(torch.bfloat16))
                            for name, p in mod._parameters.items()
                            if p is not None]
        self.stamp = self._stamp()

    def _stamp(self):
        return [(id(p), p.data_ptr(), p._version)
                for p in (mod._parameters[name] for mod, name, _ in
                          self.slots)]

    def refresh(self) -> None:
        stamp = self._stamp()
        if stamp != self.stamp:
            for mod, name, copy in self.slots:
                copy.copy_(mod._parameters[name].detach())
            self.stamp = stamp

    @contextmanager
    def swapped_in(self):
        """The bf16 copies in place of the parameters, for a capture."""
        saved = [mod._parameters[name] for mod, name, _ in self.slots]
        try:
            for mod, name, copy in self.slots:
                mod._parameters[name] = copy
            yield
        finally:
            for (mod, name, _), p in zip(self.slots, saved):
                mod._parameters[name] = p


class _ARGraph:
    """The decode loop as CUDA graphs on one carry: a block of
    ``DONE_CHECK_EVERY`` steps and, when that does not divide
    ``max_steps``, the tail block, sharing one memory pool. The encoder
    outputs, the mask and the cross K/V are copied into static tensors
    before each decode, and the bf16 weight copies (``DecodeWeights``)
    refreshed if a weight changed. Built by warming the step up on a side
    stream, then capturing, both with the copies swapped in; a failed
    capture raises."""

    def __init__(self, model: TransformerTTS, e_outputs, src_mask,
                 cross_kvs, max_steps: int, stop_threshold: float):
        self.max_steps = max_steps
        self.e_outputs = e_outputs.clone()
        self.src_mask = src_mask.clone()
        self.cross_kvs = tuple(tuple(x.clone() for x in kv)
                               for kv in cross_kvs)
        self.carry = _ar_init(model, e_outputs.shape[0], max_steps,
                              e_outputs.device)
        body = _ar_body(model, self.e_outputs, self.src_mask,
                        self.cross_kvs, stop_threshold)
        self.weights = DecodeWeights(model)
        side = torch.cuda.Stream(e_outputs.device)
        side.wait_stream(torch.cuda.current_stream(e_outputs.device))
        with torch.cuda.stream(side), self.weights.swapped_in():
            for _ in range(min(3, max_steps)):
                body(self.carry)
        torch.cuda.current_stream(e_outputs.device).wait_stream(side)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        pool = None
        for n in sorted({min(DONE_CHECK_EVERY, max_steps),
                         max_steps % DONE_CHECK_EVERY} - {0}, reverse=True):
            _ar_reset(self.carry, max_steps)
            graph = torch.cuda.CUDAGraph()
            with self.weights.swapped_in(), \
                    torch.cuda.graph(graph, pool=pool):
                for _ in range(n):
                    body(self.carry)
            pool = graph.pool()
            self.graphs[n] = graph

    def decode(self, e_outputs, src_mask, cross_kvs) -> Dict[str, object]:
        self.e_outputs.copy_(e_outputs)
        self.src_mask.copy_(src_mask)
        for static, fresh in zip(self.cross_kvs, cross_kvs):
            for s, f in zip(static, fresh):
                s.copy_(f)
        self.weights.refresh()
        _ar_reset(self.carry, self.max_steps)
        _run_blocks(lambda n: self.graphs[n].replay(), self.carry["done"],
                    self.max_steps)
        return self.carry


# model -> {(B, text length, max_steps, dtype, threshold, device): graph}
_AR_GRAPHS: "weakref.WeakKeyDictionary[TransformerTTS, dict]" = \
    weakref.WeakKeyDictionary()


def ar_decode_graphed(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
                      max_steps: int, stop_threshold: float
                      ) -> Dict[str, object]:
    """``ar_decode`` replayed from CUDA graphs (CUDA tensors only): the
    same steps, the same host checks of ``done``, the same carry. The
    graphs are kept for later calls at the same batch size, text length,
    ``max_steps``, dtype and stop threshold, as JAX keeps one compiled
    ``while_loop`` per shape. The returned carry is the graph's own, valid
    until the next decode at that key."""
    if e_outputs.device.type != "cuda":
        raise ValueError(f"the graphed decode runs on CUDA tensors, not "
                         f"{e_outputs.device}")
    key = (e_outputs.shape[0], e_outputs.shape[1], max_steps,
           model.cache_dtype, float(stop_threshold), e_outputs.device)
    graphs = _AR_GRAPHS.setdefault(model, {})
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = _ARGraph(model, e_outputs, src_mask,
                                       cross_kvs, max_steps, stop_threshold)
    return graph.decode(e_outputs, src_mask, cross_kvs)


@torch.inference_mode()
def synthesize_transformer_tts(
    model: TransformerTTS, text: torch.Tensor, pos_text: torch.Tensor,
    mean: Optional[torch.Tensor] = None, var: Optional[torch.Tensor] = None,
    *, max_steps: int = MAX_AR_STEPS, stop_threshold: float = 0.5,
    eager: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached AR synthesis; returns (mel (B, max_steps*r, mel) fp32,
    lengths (B,) in frames).

    The encoder and the cross-attention K/V run once; then one
    ``decode_step`` per frame group, on static shapes, up to ``max_steps``
    groups: on a CUDA device replayed from CUDA graphs
    (``ar_decode_graphed``), on the CPU, or with ``eager=True``, the eager
    loop (``ar_decode``, the graph's reference). The JAX package's
    ``while_loop`` stops as soon as every row has stopped; here the host
    reads ``done`` only every ``DONE_CHECK_EVERY`` steps, so as not to
    wait for the card at each one, and may run up to ``DONE_CHECK_EVERY -
    1`` steps more. Those change no output: a row's length is fixed at its
    first stop, the frames past it are zeroed, and the causal postnet (run
    once over all ``max_steps`` groups, as in JAX) lets no later frame
    reach an earlier one. Frames past a row's length are 0; with
    ``mean``/``var`` the rest are de-normalized.
    """
    _ar_check(model)
    model.eval()
    b, r, mel_dim = text.shape[0], model.reduction_rate, model.mel_dim
    src_mask = pad_mask(pos_text)
    e_outputs, _ = model.encode(text, src_mask)
    cross_kvs = model.precompute_cross_kv(e_outputs)
    decode = (ar_decode if eager or text.device.type == "cpu"
              else ar_decode_graphed)
    carry = decode(model, e_outputs, src_mask, cross_kvs, max_steps,
                   stop_threshold)
    post = model.apply_postnet(carry["groups"].to(model.cache_dtype))
    mel = post.float().reshape(b, max_steps * r, mel_dim)
    lengths = carry["length"] * r
    valid = (torch.arange(max_steps * r, device=mel.device)[None, :]
             < lengths[:, None])[:, :, None]
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    mel = torch.where(valid, mel, torch.zeros((), device=mel.device))
    return mel, lengths
