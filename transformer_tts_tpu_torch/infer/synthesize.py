"""Synthesis (the port of ``denormalize``, ``sample_perturbation``,
``synthesize_fastspeech2`` and the AR decode of ``_ar_check``, ``_ar_init``,
``_ar_body`` and ``synthesize_transformer_tts``,
transformer_tts_tpu/infer/synthesize.py:39-87 and :186-301), and the
synthesis CLI's per-utterance vocoding (``vocode_utterance``, the neural
branch of ``_write_wav``, transformer_tts_tpu/cli/synthesize.py:247-262).

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
``ar_segment`` runs a caller's own carry a few steps further, on the same
graphs (the streaming decode of infer/streaming.ARStream).

The Tacotron 2 decoder (``synthesize_tacotron2``, the port of the JAX
file's :305-334, and ``tacotron2_decode``) runs its zoneout-LSTM loop the
same way: the eager loop on the CPU, CUDA graphs of ``DONE_CHECK_EVERY``
steps on the card, the carry (both cells' states, the fed-back frame, the
cumulative alignment, the step, the stop tail, ``done`` and the length)
in static buffers, and ``AttentionEncoderProj`` of the encoder output a
static input computed once per call. Steps run past the stop inside a
block change neither the length nor ``done``, and never run past
``max_steps``; the causal postnet lets no later frame reach an earlier
one, and the frames past the length are zeroed.

A multi-speaker AR model's decoder layers add a speaker bias that is the
same at every step: the call computes it once, before the decode
(``TransformerTTS.speaker_biases``), and the steps read it. In the graph
it is one more static input, copied in before every decode and segment
like the encoder outputs, so a replay reads this call's speakers, never
the speakers of the call that captured it.
"""

from __future__ import annotations

import random
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from transformer_tts_tpu_torch.data.batching import pick_bucket
from transformer_tts_tpu_torch.models.fastspeech2 import FastSpeech2
from transformer_tts_tpu_torch.models.tacotron2_decoder import text_mask
from transformer_tts_tpu_torch.models.transformer_tts import TransformerTTS
from transformer_tts_tpu_torch.ops.masks import pad_mask

PERTURBATION_CHOICES = (0.8, 0.9, 1.0, 1.1, 1.2)
MAX_AR_STEPS = 500          # decode steps (frame groups) per utterance
DONE_CHECK_EVERY = 8        # decode steps between the host's stop checks
# The AR postnet is 5 causal convs of kernel 5 (left pad 4 each): output
# group t reads groups [t - 20, t] only. Streaming applies it over a
# window with this many groups of context (infer/streaming.ARStream).
POSTNET_LOOKBACK = 20


def sample_perturbation(rng: Optional[random.Random] = None) -> float:
    r = rng or random
    return r.choice(PERTURBATION_CHOICES)


def denormalize(mel: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor) -> torch.Tensor:
    return mel * torch.sqrt(var) + mean


@torch.inference_mode()
def vocode_utterance(vocoder: nn.Module, mel: torch.Tensor,
                     buckets: Sequence[int] = ()) -> torch.Tensor:
    """One utterance's de-normalized (T, mel_dim) log-mel -> its
    (T * hop,) waveform: T zero-padded to a bucket of ``buckets`` (so
    repeated calls reuse a few shapes), the generator in its own
    precision, the padding's samples cut off."""
    n = mel.shape[0]
    t = pick_bucket(n, buckets) if buckets else n
    mel_pad = mel.new_zeros((1, t, mel.shape[1]), dtype=torch.float32)
    mel_pad[0, :n] = mel
    return vocoder(mel_pad)[0, :n * vocoder.hop_length]


@torch.inference_mode()
def synthesize_fastspeech2(
    model: FastSpeech2, text: torch.Tensor, pos_text: torch.Tensor,
    max_frames: int, mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None, *, spk_emb=None, accent=None,
    hop_size=None, pitch_scale: float = 1.0, duration_scale: float = 1.0,
    use_prenet: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward; returns (mel (B, T, mel), mel_len (B,), durations (B, L)).

    A conditioned model takes ``spk_emb`` ((B,) ids or (B, 512)
    x-vectors), ``accent`` (B, L) and ``hop_size`` (B,). ``durations``
    are the unscaled predictions, 0 on padded phones, as the JAX function
    returns them.
    """
    model.eval()
    src_mask = pad_mask(pos_text)
    cond = {k: v for k, v in (("spk_emb", spk_emb), ("accent", accent),
                              ("hop_size", hop_size)) if v is not None}
    out = model(text, src_mask, max_frames, pitch_scale=pitch_scale,
                duration_scale=duration_scale, **cond)
    mel = out.mel_pre if use_prenet or out.mel_post is None else out.mel_post
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    durations = torch.round(
        torch.exp(out.log_duration.float()) - model.log_offset).clamp(min=0)
    durations = torch.where(src_mask[:, 0, :], durations,
                            torch.zeros_like(durations))
    return mel, out.mel_len, durations.to(torch.int32)


def _ar_check(model: TransformerTTS) -> None:
    """The incremental decode is the transformer decoder's, and causal
    only with a 1-wide decoder FFN (its conv is SAME-padded)."""
    if model.is_tacotron2:
        raise ValueError("decoder_type='tacotron2' uses "
                         "synthesize_tacotron2 (zoneout-LSTM loop), not "
                         "the KV-cached transformer decode")
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
             stop_threshold: float, spk_biases=None):
    """One decode step on the carry, in place (``spk_biases``: the call's
    ``model.speaker_biases``, or None): the group at ``step``, the
    stop rule (the mean of the r stop probabilities above
    ``stop_threshold``; ``length`` is set at a row's first stop), and the
    next input, the first frame of the predicted group. Every update
    writes into the carry's own tensors, so a captured step reads and
    writes fixed addresses."""
    mel_dim = model.mel_dim

    def body(c):
        step = c["step"]
        group, stop = model.decode_step(c["prev"], e_outputs, src_mask,
                                        c["caches"], step, cross_kvs,
                                        spk_biases)
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


def _copy_carry(dst: Dict[str, object], src: Dict[str, object]) -> None:
    for key in ("step", "prev", "groups", "done", "length"):
        dst[key].copy_(src[key])
    for dst_kv, src_kv in zip(dst["caches"], src["caches"]):
        for d, s in zip(dst_kv, src_kv):
            d.copy_(s)


def _run_blocks(run_block: Callable[[int], None], done: torch.Tensor,
                n_steps: int) -> None:
    """``n_steps`` decode steps as blocks of ``DONE_CHECK_EVERY`` (the
    last one shorter when the block does not divide ``n_steps``), the
    host reading ``done`` before every block but the first and stopping
    once every row is done."""
    for first in range(0, n_steps, DONE_CHECK_EVERY):
        if first and bool(done.all()):
            break
        run_block(min(DONE_CHECK_EVERY, n_steps - first))


def _capture_blocks(body: Callable[[], None], reset: Callable[[], None],
                    max_steps: int, device, swapped_in) -> Dict[int, object]:
    """CUDA graphs of a decode loop's ``body`` (one in-place step on a
    carry): a block of ``DONE_CHECK_EVERY`` steps and, when that does not
    divide ``max_steps``, the tail block, sharing one memory pool, each
    captured from the ``reset`` carry after a warm-up of three steps on a
    side stream, all with ``swapped_in()`` (the bf16 weight copies) in
    place. -> {steps: graph}; a failed capture raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), swapped_in():
        for _ in range(min(3, max_steps)):
            body()
    torch.cuda.current_stream(device).wait_stream(side)
    graphs: Dict[int, torch.cuda.CUDAGraph] = {}
    pool = None
    for n in sorted({min(DONE_CHECK_EVERY, max_steps),
                     max_steps % DONE_CHECK_EVERY} - {0}, reverse=True):
        reset()
        graph = torch.cuda.CUDAGraph()
        with swapped_in(), torch.cuda.graph(graph, pool=pool):
            for _ in range(n):
                body()
        pool = graph.pool()
        graphs[n] = graph
    return graphs


def ar_decode(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
              max_steps: int, stop_threshold: float,
              spk_biases=None) -> Dict[str, object]:
    """The eager decode loop: a fresh carry, then ``_ar_body`` step by step
    under ``_run_blocks``. Returns the carry (``groups``, ``length``)."""
    carry = _ar_init(model, e_outputs.shape[0], max_steps, e_outputs.device)
    body = _ar_body(model, e_outputs, src_mask, cross_kvs, stop_threshold,
                    spk_biases)

    def run_block(n):
        for _ in range(n):
            body(carry)

    _run_blocks(run_block, carry["done"], max_steps)
    return carry


def _flat_carry(carry: Dict[str, object]) -> Tuple[torch.Tensor, ...]:
    return (carry["step"], carry["prev"], carry["groups"], carry["done"],
            carry["length"], *(x for kv in carry["caches"] for x in kv))


def _carry_of(flat) -> Dict[str, object]:
    step, prev, groups, done, length, *caches = flat
    return dict(step=step, prev=prev, groups=groups, done=done,
                length=length,
                caches=tuple(zip(caches[0::2], caches[1::2])))


def ar_decode_loop(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
                   max_steps: int, stop_threshold: float,
                   spk_biases=None) -> Dict[str, object]:
    """The decode as one ``torch.while_loop``, the form ``torch.export``
    captures (``infer/engine.TTSEngine.export``): it stops when every row
    is done or at ``max_steps``, as the JAX package's ``while_loop`` does,
    with no block of ``DONE_CHECK_EVERY`` steps past the last stop. Each
    step is ``_ar_body`` on a copy of the loop's carry, so the step's
    arithmetic is the eager loop's while the loop itself writes no tensor
    it was given. Returns the final carry."""
    body = _ar_body(model, e_outputs, src_mask, cross_kvs, stop_threshold,
                    spk_biases)

    def cond_fn(*flat):
        carry = _carry_of(flat)
        return (carry["step"] < max_steps) & ~carry["done"].all()

    def body_fn(*flat):
        return _flat_carry(body(_carry_of([x.clone() for x in flat])))

    init = _ar_init(model, e_outputs.shape[0], max_steps, e_outputs.device)
    return _carry_of(torch.while_loop(cond_fn, body_fn, _flat_carry(init)))


class DecodeWeights:
    """bf16 copies of the weights and biases of every ``nn.Linear`` and
    ``nn.Conv1d`` that ``decode_step`` runs (the decoder, ``out``,
    ``stop_token``; not the layers' ``SpeakerBias``, which runs once per
    call, before the decode; for a Tacotron 2 decoder, the decoder's), for
    a bf16-amp model: with them swapped in, autocast
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
            once = {id(m) for layer in getattr(model.decoder, "layers", ())
                    if layer.spk_bias is not None
                    for m in layer.spk_bias.modules()}
            for part in (model.decoder, model.out, model.stop_token):
                if part is None:            # the Tacotron 2 decoder's heads
                    continue
                for mod in part.modules():
                    if (isinstance(mod, (nn.Linear, nn.Conv1d))
                            and id(mod) not in once):
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
                 cross_kvs, max_steps: int, stop_threshold: float,
                 spk_biases=None):
        self.max_steps = max_steps
        self.e_outputs = e_outputs.clone()
        self.src_mask = src_mask.clone()
        self.cross_kvs = tuple(tuple(x.clone() for x in kv)
                               for kv in cross_kvs)
        self.spk_biases = (tuple(x.clone() for x in spk_biases)
                           if spk_biases is not None else None)
        self.carry = _ar_init(model, e_outputs.shape[0], max_steps,
                              e_outputs.device)
        body = _ar_body(model, self.e_outputs, self.src_mask,
                        self.cross_kvs, stop_threshold, self.spk_biases)
        self.weights = DecodeWeights(model)
        self.graphs = _capture_blocks(
            lambda: body(self.carry),
            lambda: _ar_reset(self.carry, max_steps), max_steps,
            e_outputs.device, self.weights.swapped_in)

    def _load(self, e_outputs, src_mask, cross_kvs, spk_biases) -> None:
        self.e_outputs.copy_(e_outputs)
        self.src_mask.copy_(src_mask)
        for static, fresh in zip(self.cross_kvs, cross_kvs):
            for s, f in zip(static, fresh):
                s.copy_(f)
        if self.spk_biases is not None:
            for s, f in zip(self.spk_biases, spk_biases):
                s.copy_(f)
        self.weights.refresh()

    def _run(self, n_steps: int) -> None:
        _run_blocks(lambda n: self.graphs[n].replay(), self.carry["done"],
                    n_steps)

    def decode(self, e_outputs, src_mask, cross_kvs,
               spk_biases=None) -> Dict[str, object]:
        self._load(e_outputs, src_mask, cross_kvs, spk_biases)
        _ar_reset(self.carry, self.max_steps)
        self._run(self.max_steps)
        return self.carry

    def segment(self, carry, e_outputs, src_mask, cross_kvs,
                n_steps: int, spk_biases=None) -> None:
        """``n_steps`` more steps of ``carry``, a carry of the caller's own
        (its step a multiple of ``DONE_CHECK_EVERY``): copied into the
        graph's carry, replayed, copied back, so that decodes and other
        callers' segments in between at this key change nothing of it;
        ``spk_biases`` are the caller's speakers, loaded like the encoder
        outputs."""
        self._load(e_outputs, src_mask, cross_kvs, spk_biases)
        _copy_carry(self.carry, carry)
        self._run(n_steps)
        _copy_carry(carry, self.carry)


# model -> {(B, text length, max_steps, dtype, threshold, device,
#           speakers or not): graph}
_AR_GRAPHS: "weakref.WeakKeyDictionary[TransformerTTS, dict]" = \
    weakref.WeakKeyDictionary()


def ar_decode_graphed(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
                      max_steps: int, stop_threshold: float,
                      spk_biases=None) -> Dict[str, object]:
    """``ar_decode`` replayed from CUDA graphs (CUDA tensors only): the
    same steps, the same host checks of ``done``, the same carry. The
    graphs are kept for later calls at the same batch size, text length,
    ``max_steps``, dtype and stop threshold, as JAX keeps one compiled
    ``while_loop`` per shape. The returned carry is the graph's own, valid
    until the next decode at that key."""
    return _graph(model, e_outputs, src_mask, cross_kvs, max_steps,
                  stop_threshold, spk_biases).decode(e_outputs, src_mask,
                                                     cross_kvs, spk_biases)


def _graph(model: TransformerTTS, e_outputs, src_mask, cross_kvs,
           max_steps: int, stop_threshold: float,
           spk_biases=None) -> _ARGraph:
    if e_outputs.device.type != "cuda":
        raise ValueError(f"the graphed decode runs on CUDA tensors, not "
                         f"{e_outputs.device}")
    key = (e_outputs.shape[0], e_outputs.shape[1], max_steps,
           model.cache_dtype, float(stop_threshold), e_outputs.device,
           spk_biases is not None)
    graphs = _AR_GRAPHS.setdefault(model, {})
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = _ARGraph(model, e_outputs, src_mask,
                                       cross_kvs, max_steps, stop_threshold,
                                       spk_biases)
    return graph


def ar_segment(model: TransformerTTS, carry, e_outputs, src_mask, cross_kvs,
               n_steps: int, stop_threshold: float,
               spk_biases=None) -> None:
    """``n_steps`` more decode steps of the caller's own ``carry``
    (``_ar_init``'s, at a step that is a multiple of ``DONE_CHECK_EVERY``),
    in place, as blocks under ``_run_blocks``: on a CUDA device replayed
    from the graphs ``ar_decode_graphed`` keeps for this key (the carry
    copied in and out, ``_ARGraph.segment``), on the CPU the eager loop."""
    if e_outputs.device.type == "cpu":
        body = _ar_body(model, e_outputs, src_mask, cross_kvs,
                        stop_threshold, spk_biases)

        def run_block(n):
            for _ in range(n):
                body(carry)

        _run_blocks(run_block, carry["done"], n_steps)
        return
    _graph(model, e_outputs, src_mask, cross_kvs, carry["groups"].shape[1],
           stop_threshold, spk_biases).segment(carry, e_outputs, src_mask,
                                               cross_kvs, n_steps,
                                               spk_biases)


@torch.inference_mode()
def synthesize_transformer_tts(
    model: TransformerTTS, text: torch.Tensor, pos_text: torch.Tensor,
    mean: Optional[torch.Tensor] = None, var: Optional[torch.Tensor] = None,
    *, spk_emb: Optional[torch.Tensor] = None,
    ref_mel: Optional[torch.Tensor] = None,
    max_steps: int = MAX_AR_STEPS, stop_threshold: float = 0.5,
    eager: bool = False, loop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached AR synthesis; returns (mel (B, max_steps*r, mel) fp32,
    lengths (B,) in frames). A GST model takes its style from ``ref_mel``
    (B or 1, T, mel), a normalized reference mel; one of (1, T, mel)
    styles every row. It goes into the encoder only, before the decode.
    A multi-speaker model takes ``spk_emb``, (B,) ids or (B, 512)
    x-vectors: into the encoder, and into the decoder layers' biases,
    computed once before the decode.

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
    ``mean``/``var`` the rest are de-normalized. ``loop=True`` runs the
    decode as one ``torch.while_loop`` instead (``ar_decode_loop``: JAX's
    stop, no step past it), the form an exported artifact holds.
    """
    _ar_check(model)
    model.eval()
    b, r, mel_dim = text.shape[0], model.reduction_rate, model.mel_dim
    src_mask = pad_mask(pos_text)
    e_outputs, _ = model.encode(text, src_mask, ref_mel, spk_emb)
    cross_kvs = model.precompute_cross_kv(e_outputs)
    decode = (ar_decode_loop if loop
              else ar_decode if eager or text.device.type == "cpu"
              else ar_decode_graphed)
    carry = decode(model, e_outputs, src_mask, cross_kvs, max_steps,
                   stop_threshold, model.speaker_biases(spk_emb))
    post = model.apply_postnet(carry["groups"].to(model.cache_dtype))
    mel = post.float().reshape(b, max_steps * r, mel_dim)
    lengths = carry["length"] * r
    valid = (torch.arange(max_steps * r, device=mel.device)[None, :]
             < lengths[:, None])[:, :, None]
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    mel = torch.where(valid, mel, torch.zeros((), device=mel.device))
    return mel, lengths


# ---- the Tacotron 2 decoder ------------------------------------------------

class _Tacotron2Graph:
    """The Tacotron 2 synthesis loop as CUDA graphs on one carry
    (``_capture_blocks``); the encoder output, its ``AttentionEncoderProj``
    and the text mask are copied into static tensors before each decode
    and the bf16 weight copies refreshed, as ``_ARGraph`` does."""

    def __init__(self, model: TransformerTTS, e_outputs, enc_proj, e_mask,
                 max_steps: int):
        dec = model.decoder
        b, input_len = e_outputs.shape[:2]
        self.max_steps = max_steps
        self.e_outputs = e_outputs.clone()
        self.enc_proj = enc_proj.clone()
        self.e_mask = e_mask.clone() if e_mask is not None else None
        self.initial = dec.synthesis_carry(b, input_len, max_steps,
                                           e_outputs.device)
        self.carry = {k: v.clone() for k, v in self.initial.items()}
        self.weights = DecodeWeights(model)

        def body():
            with model._autocast(self.e_outputs):
                dec.synthesis_step(self.carry, self.e_outputs,
                                   self.enc_proj, self.e_mask)

        self.graphs = _capture_blocks(body, self._reset, max_steps,
                                      e_outputs.device,
                                      self.weights.swapped_in)

    def _reset(self) -> None:
        for key, value in self.initial.items():
            self.carry[key].copy_(value)

    def decode(self, e_outputs, enc_proj, e_mask) -> Dict[str, torch.Tensor]:
        self.e_outputs.copy_(e_outputs)
        self.enc_proj.copy_(enc_proj)
        if self.e_mask is not None:
            self.e_mask.copy_(e_mask)
        self.weights.refresh()
        self._reset()
        _run_blocks(lambda n: self.graphs[n].replay(), self.carry["done"],
                    self.max_steps)
        return self.carry


# model -> {(B, text length, max_steps, dtype, device, masked): graph}
_TACOTRON2_GRAPHS: "weakref.WeakKeyDictionary[TransformerTTS, dict]" = \
    weakref.WeakKeyDictionary()


def tacotron2_decode(model: TransformerTTS, e_outputs,
                     text_lengths: Optional[torch.Tensor], max_steps: int,
                     *, eager: bool = False) -> Dict[str, torch.Tensor]:
    """The Tacotron 2 synthesis loop over ``e_outputs`` (B, L, d), the
    attention masked past ``text_lengths`` when given: ``max_steps`` steps
    at most, as blocks under ``_run_blocks``, the host reading ``done``
    before each block. On a CUDA device (unless ``eager``) replayed from
    CUDA graphs kept per (B, L, ``max_steps``, dtype, mask or not), else
    the eager loop. Returns the carry (``groups`` (B, max_steps, mel*r)
    fp32, ``length`` (B,) in groups)."""
    dec = model.decoder
    e_mask = text_mask(text_lengths, e_outputs.shape[1])
    with model._autocast(e_outputs):
        enc_proj = dec.AttentionEncoderProj(e_outputs)
    if eager or e_outputs.device.type != "cuda":
        carry = dec.synthesis_carry(e_outputs.shape[0], e_outputs.shape[1],
                                    max_steps, e_outputs.device)

        def run_block(n):
            with model._autocast(e_outputs):
                for _ in range(n):
                    dec.synthesis_step(carry, e_outputs, enc_proj, e_mask)

        _run_blocks(run_block, carry["done"], max_steps)
        return carry
    key = (e_outputs.shape[0], e_outputs.shape[1], max_steps,
           model.cache_dtype, e_outputs.device, e_mask is not None)
    graphs = _TACOTRON2_GRAPHS.setdefault(model, {})
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = _Tacotron2Graph(model, e_outputs, enc_proj,
                                              e_mask, max_steps)
    return graph.decode(e_outputs, enc_proj, e_mask)


@torch.inference_mode()
def synthesize_tacotron2(
    model: TransformerTTS, text: torch.Tensor, pos_text: torch.Tensor,
    mean: Optional[torch.Tensor] = None, var: Optional[torch.Tensor] = None,
    *, spk_emb: Optional[torch.Tensor] = None,
    ref_mel: Optional[torch.Tensor] = None,
    max_steps: int = MAX_AR_STEPS, eager: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesis through the Tacotron 2 decoder
    (``TransformerTTS.tacotron2_synthesize``, its attention masked by
    the text lengths of ``pos_text``); returns (mel (B, max_steps*r, mel)
    fp32 after the postnet, lengths (B,) in frames, every row's the same:
    the stop rule reads row 0). Frames past the length are 0; with
    ``mean``/``var`` the rest are de-normalized."""
    model.eval()
    src_mask = pad_mask(pos_text)
    mel, lengths = model.tacotron2_synthesize(
        text, src_mask, src_mask[:, 0, :].sum(-1), spk_emb, ref_mel,
        max_steps, eager=eager)
    valid = (torch.arange(mel.shape[1], device=mel.device)[None, :]
             < lengths[:, None])[:, :, None]
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    mel = torch.where(valid, mel, torch.zeros((), device=mel.device))
    return mel, lengths
