"""Streaming synthesis (the port of transformer_tts_tpu/infer/streaming.py:
``vocode_pinned``, ``receptive_field_frames``, ``StreamingVocoder``,
``VocoderSession`` and ``ARStream``, :52-369). Streamed output equals the
one-shot output; streaming buys time to first audio, not other audio.

* ``StreamingVocoder``: the vocoder over windows of ``chunk + 2 *
  overlap`` frames, each trimmed by its overlap. Every convolution of the
  generators is SAME-padded, so where ``overlap`` covers the receptive
  field (``receptive_field_frames``) a window reproduces the one-shot
  samples; windows flush with the buffer's ends reproduce its edges.
  ``VocoderSession`` does the same while the mel arrives in pieces.
* ``vocode_pinned``: the generator in fp32 with TF32 off for cuDNN's
  convolutions and for matmuls, the role of JAX's
  ``default_matmul_precision("float32")`` pin. It is part of the exactness
  contract: a window and the full buffer are different shapes, and TF32
  rounds them differently. The synthesis CLI's ``--vocoder`` keeps TF32.
  The flags are process-wide: callers on several threads hold one lock
  around it (infer/engine.py).
* ``ARStream``: the KV-cached AR decode (infer/synthesize.py) in segments
  of ``segment_steps`` steps, a multiple of ``DONE_CHECK_EVERY``, each
  followed by the causal postnet over the last ``segment_steps +
  POSTNET_LOOKBACK`` groups, which is exact because every postnet conv is
  left-padded causal. Each stream keeps its own carry (KV caches, groups,
  step, ``done``, lengths): on the card the segments replay the decode's
  shared CUDA graphs, and ``ar_segment`` copies the carry in before and
  out after, so other requests at the same graph key between two
  segments change nothing of it. The graphs run blocks of 8 steps, so a
  segment may run up to 7 groups past the last row's stop, where JAX's
  loop stops at once; those groups are zero after masking and the
  stream's chunks end at the longest row's length, so a stream yields no
  frame at or past it. A stream keeps its speaker with its carry: the
  decoder layers' speaker biases, computed once when it starts and loaded
  into the graph before each of its segments.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from transformer_tts_tpu_torch.infer.synthesize import (
    DONE_CHECK_EVERY, MAX_AR_STEPS, POSTNET_LOOKBACK, _ar_check, _ar_init,
    ar_segment, denormalize)
from transformer_tts_tpu_torch.models.transformer_tts import TransformerTTS
from transformer_tts_tpu_torch.ops.masks import pad_mask


@torch.inference_mode()
def vocode_pinned(gen: nn.Module, mel: torch.Tensor) -> torch.Tensor:
    """``gen`` on the fp32 ``mel`` (B, T, mel_dim) with TF32 off."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return gen(mel.float())
    finally:
        matmul.allow_tf32 = saved


def receptive_field_frames(gen: nn.Module) -> int:
    """The generator's receptive-field radius in mel frames (ceil): its
    own ``receptive_field_radius_frames`` where it has one (the iSTFT
    vocoder), else HiFi-GAN's from the architecture: conv_pre (k 7), per
    upsampling stage the upsampling conv (a transposed one reads ceil(k /
    2r) + 1 input positions) and the worst MRF resblock chain, conv_post
    (k 7); a conv of kernel k and dilation d at ``up`` samples per frame
    adds ((k - 1) // 2) * d / up frames."""
    own = getattr(gen, "receptive_field_radius_frames", None)
    if own is not None:
        return int(own)
    rf = 3.0
    up = 1
    for i, r in enumerate(gen.upsample_rates):
        if gen.upsample_mode == "subpixel":
            rf += (gen.subpixel_kernel_size // 2) / up
        else:
            k = gen.upsample_kernel_sizes[i]
            rf += (math.ceil(k / (2 * r)) + 1) / up
        up *= r
        worst = max(
            sum(((rk - 1) // 2) * d + (rk - 1) // 2 for d in dils)
            for rk, dils in zip(gen.resblock_kernel_sizes,
                                gen.resblock_dilations))
        rf += worst / up
    rf += 3.0 / up
    return int(math.ceil(rf))


def _to_numpy(wav: torch.Tensor) -> np.ndarray:
    return wav.float().cpu().numpy()


class StreamingVocoder:
    """Windowed vocoding over a fixed-size mel buffer, equal to the
    one-shot vocode: every window is (B, chunk + 2 * overlap, mel_dim)."""

    def __init__(self, gen: nn.Module, *, chunk_frames: int = 64,
                 overlap_frames: Optional[int] = None):
        self.gen = gen
        self.hop = gen.hop_length
        rf = receptive_field_frames(gen)
        self.overlap = (int(overlap_frames) if overlap_frames is not None
                        else -(-rf // 8) * 8)
        if self.overlap < rf:
            raise ValueError(
                f"overlap_frames={self.overlap} < receptive field {rf}: "
                "streamed chunks would differ from the one-shot vocode")
        self.chunk = int(chunk_frames)
        self.window = self.chunk + 2 * self.overlap

    def _device(self) -> torch.device:
        return next(self.gen.parameters()).device

    def stream(self, mel, length: Optional[int] = None
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start_sample, wav)`` chunks covering ``[0, length *
        hop)`` of the one-shot vocode of ``mel`` ((T, mel_dim) or (B, T,
        mel_dim), a tensor or an array; T the padded buffer); wav is (n,)
        or (B, n) float32."""
        mel = torch.as_tensor(mel, dtype=torch.float32,
                              device=self._device())
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        t_buf = mel.shape[1]
        n = min(int(length) if length is not None else t_buf, t_buf)
        if t_buf <= self.window:
            out = _to_numpy(vocode_pinned(self.gen, mel)[:, :n * self.hop])
            yield 0, (out[0] if squeeze else out)
            return
        s = 0
        while s < n:
            e = min(s + self.chunk, n)
            ws = min(max(s - self.overlap, 0), t_buf - self.window)
            wav = vocode_pinned(self.gen, mel[:, ws:ws + self.window])
            out = _to_numpy(wav[:, (s - ws) * self.hop:(e - ws) * self.hop])
            yield s * self.hop, (out[0] if squeeze else out)
            s = e

    def session(self, total_frames: int, batch: int = 1,
                mel_dim: Optional[int] = None) -> "VocoderSession":
        return VocoderSession(self, total_frames, batch,
                              mel_dim or self.gen.mel_dim)


class VocoderSession:
    """Vocoding while the mel arrives in pieces (the AR decode): a chunk of
    audio goes out once every frame its window reads has been fed. Fed
    frames must be final, frames past a row's length already zero (as
    ``ARStream``'s are); ``finish`` zeroes the rows past their final
    lengths and flushes the rest, so the emissions equal the one-shot
    vocode of the masked buffer, trimmed to ``max(lengths)`` frames."""

    def __init__(self, sv: StreamingVocoder, total_frames: int,
                 batch: int, mel_dim: int):
        if total_frames < sv.window:
            raise ValueError(
                f"total_frames={total_frames} < window={sv.window}; use "
                "StreamingVocoder.stream on the whole buffer instead")
        self._sv = sv
        self._buf = torch.zeros(batch, total_frames, mel_dim,
                                device=sv._device())
        self._frontier = 0                 # frames fed so far
        self._emitted = 0                  # frames emitted so far

    def _window_start(self, s: int) -> int:
        sv = self._sv
        return min(max(s - sv.overlap, 0), self._buf.shape[1] - sv.window)

    def _emit(self, e: int) -> Tuple[int, np.ndarray]:
        sv = self._sv
        s = self._emitted
        ws = self._window_start(s)
        wav = vocode_pinned(sv.gen, self._buf[:, ws:ws + sv.window])
        self._emitted = e
        return s * sv.hop, _to_numpy(
            wav[:, (s - ws) * sv.hop:(e - ws) * sv.hop])

    def feed(self, mel_chunk) -> list:
        """Append (B, t, mel_dim) frames; return the wav chunks now ready,
        as ``(start_sample, wav (B, n))``."""
        mel_chunk = torch.as_tensor(mel_chunk, dtype=torch.float32,
                                    device=self._buf.device)
        t = mel_chunk.shape[1]
        if self._frontier + t > self._buf.shape[1]:
            raise ValueError("fed past the session buffer")
        self._buf[:, self._frontier:self._frontier + t] = mel_chunk
        self._frontier += t
        out = []
        t_buf = self._buf.shape[1]
        while self._emitted < t_buf:
            if (self._window_start(self._emitted) + self._sv.window
                    > self._frontier):
                break                    # the window's frames are not all in
            out.append(self._emit(min(self._emitted + self._sv.chunk,
                                      t_buf)))
        return out

    def finish(self, lengths) -> list:
        """Zero each row past its length, flush the tail; return the
        remaining ``(start_sample, wav)`` chunks."""
        lengths = np.asarray(lengths).reshape(-1)
        n = int(lengths.max()) if lengths.size else 0
        for b, ln in enumerate(lengths):
            self._buf[b, int(ln):] = 0.0
        out = []
        while self._emitted < n:
            out.append(self._emit(min(self._emitted + self._sv.chunk, n)))
        return out


def _postnet_window(model: TransformerTTS, groups, end: int, length,
                    mean, var, window: int) -> Tuple[torch.Tensor, int]:
    """The causal postnet and de-normalization over ``window`` groups
    ending at ``end`` (or starting at 0): (frames (B, window * r, mel)
    fp32, zero past each row's ``length`` groups, start group). Any
    emitted group either starts the signal or has ``POSTNET_LOOKBACK``
    groups before it in the window, so it equals the one-shot value."""
    max_steps = groups.shape[1]
    r, mel_dim = model.reduction_rate, model.mel_dim
    start = min(max(end - window, 0), max_steps - window)
    post = model.apply_postnet(
        groups[:, start:start + window].to(model.cache_dtype))
    frames = post.float().reshape(groups.shape[0], window * r, mel_dim)
    idx = start * r + torch.arange(window * r, device=frames.device)
    valid = (idx[None, :] < (length * r)[:, None])[:, :, None]
    if mean is not None and var is not None:
        frames = denormalize(frames, mean, var)
    frames = torch.where(valid, frames, torch.zeros((), device=frames.device))
    return frames, start


class ARStream:
    """The segmented AR decode. Iterating yields ``(start_frame, mel_chunk
    (B, t, mel) fp32 tensor)`` with the values of the one-shot
    ``synthesize_transformer_tts`` (de-normalized, zero past each row's
    length), up to the longest row's length; afterwards ``lengths`` holds
    the (B,) lengths in frames (numpy)."""

    def __init__(self, model: TransformerTTS, text: torch.Tensor,
                 pos_text: torch.Tensor, mean: Optional[torch.Tensor] = None,
                 var: Optional[torch.Tensor] = None, *,
                 spk_emb: Optional[torch.Tensor] = None,
                 ref_mel: Optional[torch.Tensor] = None,
                 max_steps: int = MAX_AR_STEPS, segment_steps: int = 32,
                 stop_threshold: float = 0.5):
        _ar_check(model)
        if segment_steps <= 0 or segment_steps % DONE_CHECK_EVERY:
            raise ValueError(
                f"segment_steps={segment_steps} must be a positive multiple "
                f"of DONE_CHECK_EVERY ({DONE_CHECK_EVERY}): the decode runs "
                "in graph blocks of that many steps")
        self.model = model
        self.text, self.pos_text = text, pos_text
        self.mean, self.var, self.ref_mel = mean, var, ref_mel
        self.spk_emb = spk_emb
        self.max_steps = int(max_steps)
        self.segment_steps = int(segment_steps)
        self.stop_threshold = float(stop_threshold)
        self.lengths: Optional[np.ndarray] = None

    def __iter__(self) -> Iterator[Tuple[int, torch.Tensor]]:
        model = self.model
        model.eval()
        r = model.reduction_rate
        with torch.inference_mode():
            src_mask = pad_mask(self.pos_text)
            e_outputs, _ = model.encode(self.text, src_mask, self.ref_mel,
                                        self.spk_emb)
            cross_kvs = model.precompute_cross_kv(e_outputs)
            spk_biases = model.speaker_biases(self.spk_emb)
            carry = _ar_init(model, self.text.shape[0], self.max_steps,
                             self.text.device)
        window = min(self.segment_steps + POSTNET_LOOKBACK, self.max_steps)
        step = emitted = 0
        while True:
            with torch.inference_mode():
                ar_segment(model, carry, e_outputs, src_mask, cross_kvs,
                           min(self.segment_steps, self.max_steps - step),
                           self.stop_threshold, spk_biases)
                step = int(carry["step"])
                end = min(step, int(carry["length"].max()))
                frames, start = _postnet_window(
                    model, carry["groups"], step, carry["length"],
                    self.mean, self.var, window)
            yield emitted * r, frames[:, (emitted - start) * r:
                                      (end - start) * r]
            emitted = end
            if step >= self.max_steps or bool(carry["done"].all()):
                break
        self.lengths = (carry["length"] * r).cpu().numpy()
