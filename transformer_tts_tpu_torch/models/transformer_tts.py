"""The autoregressive Transformer-TTS (the port of ``TransformerTTS`` and
``build_transformer_tts``, transformer_tts_tpu/models/transformer_tts.py:
55-291).

Text encoder (transformer or conformer stack) -> AR decoder over frame
groups of ``reduction_rate`` frames -> ``out`` (d -> mel*r, the pre mel)
and ``stop_token`` (d -> r logits) -> the causal conv postnet in its AR
mode (``prev_version=False``: the pre mel in, the post mel out). Outputs
keep the grouped layout: mel (B, t, mel*r) and stop logits (B, t, r).

* ``forward``: the teacher-forced pass of training (train mode) and of
  an eval forward; the decoder's masked self-attention takes K3.
* ``encode``, ``precompute_cross_kv``, ``decode_step`` and
  ``apply_postnet``: the pieces the KV-cached decode loop
  (infer/synthesize.synthesize_transformer_tts) drives; no kernel runs
  in ``decode_step``, which reads no host value, so the loop captures it
  in a CUDA graph.

``gst`` adds the style vector of a reference mel (models/gst.py,
``StyleEmbedding``) to every encoder output, after the optional
``linear``: the training target's decoder input in train mode unless a
``ref_mel`` is given, the ``ref_mel`` otherwise; a (1, T, mel) reference
broadcasts over the batch. ``amp`` runs each under bf16 autocast, as
FastSpeech 2 does.

Speakers (the JAX file's :84-111, :148-164): ``spk_emb`` is (B,) ids or
(B, 512) x-vectors. ``spk_emb_vers`` 1 gives the encoder's and the
decoder's layers that ``spk_emb_architecture`` names a ``SpeakerBias``;
the decoder's biases are computed once per call (``speaker_biases``)
and the decode steps read them. ``spk_emb_vers`` 2 adds ``spk_proj`` of
the L2-normalised speaker vector to every encoder output instead, with
no per-layer bias.

``decoder_type = "tacotron2"`` (the JAX file's :112-124, :209-227,
:240-262) replaces the decoder stack with the zoneout-LSTM
``Tacotron2Decoder`` (models/tacotron2_decoder.py), which makes the
frames and the stop logits itself: no ``out`` or ``stop_token`` head.
Its teacher-forced forward reads the full-rate target and returns the
same grouped layout; ``tacotron2_synthesize`` runs its synthesis loop
(infer/synthesize.tacotron2_decode) and the causal postnet.

``output_type`` (the discrete mode) makes the decoder prenet's fc1 an
embedding over ``mel_dim`` codes and sums its two streams
(models/decoder.py). The JAX AR step fails in this mode: it reshapes the
(B, t, mel*r) output by the targets' 2 code streams and takes an L1 of
float frames against int codes; the port's AR step refuses it
(train/trainer.py).
"""

from __future__ import annotations

from contextlib import AbstractContextManager
from typing import NamedTuple, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams, spk_arch
from transformer_tts_tpu_torch.models.decoder import Decoder
from transformer_tts_tpu_torch.models.fastspeech2 import (
    _stack, check_speakers, check_stack_type, init_parameters,
    l2_normalised)
from transformer_tts_tpu_torch.models.tacotron2_decoder import (
    Tacotron2Decoder)
from transformer_tts_tpu_torch.models.gst import StyleEmbedding
from transformer_tts_tpu_torch.models.postnets import PostConvNet


class TransformerTTSOutput(NamedTuple):
    mel_pre: torch.Tensor                    # (B, t, mel*r)
    mel_post: torch.Tensor                   # (B, t, mel*r)
    stop_token: torch.Tensor                 # (B, t, r) logits
    attn_enc: Optional[torch.Tensor]
    attn_dec_dec: Optional[torch.Tensor]
    attn_dec_enc: Optional[torch.Tensor]


class TransformerTTS(nn.Module):
    def __init__(self, vocab_size: int = 152, mel_dim: int = 80,
                 d_model_encoder: int = 384, n_layer_encoder: int = 6,
                 n_head_encoder: int = 4, ff_conv_kernel_size_encoder: int = 5,
                 concat_after_encoder: bool = False,
                 d_model_decoder: int = 384, n_layer_decoder: int = 6,
                 n_head_decoder: int = 4, ff_conv_kernel_size_decoder: int = 1,
                 concat_after_decoder: bool = False,
                 encoder_type: str = "transformer",
                 decoder_type: str = "transformer", reduction_rate: int = 2,
                 dropout: float = 0.1, dropout_prenet: float = 0.5,
                 dropout_postnet: float = 0.5, gst: bool = False,
                 spk_emb_dim: Optional[int] = None,
                 spk_emb_architecture: tuple = (), spk_emb_vers: int = 1,
                 multi_speaker: bool = False, output_type: bool = False,
                 use_flash: bool = False, amp: bool = False):
        super().__init__()
        per_layer = spk_emb_dim if spk_emb_vers == 1 else None
        self.mel_dim = mel_dim
        self.reduction_rate = reduction_rate
        self.n_layer_decoder = n_layer_decoder
        self.n_head_decoder = n_head_decoder
        self.d_model_decoder = d_model_decoder
        self.ff_conv_kernel_size_decoder = ff_conv_kernel_size_decoder
        self.amp = amp
        self.encoder = _stack(
            encoder_type, vocab_size=vocab_size, d_model=d_model_encoder,
            n_layers=n_layer_encoder, heads=n_head_encoder,
            ff_kernel_size=ff_conv_kernel_size_encoder,
            concat_after=concat_after_encoder, dropout=dropout,
            embedding=True, use_flash=use_flash,
            spk_emb_dim=(per_layer if "encoder" in spk_emb_architecture
                         else None))
        self.linear = (nn.Linear(d_model_encoder, d_model_decoder)
                       if d_model_encoder != d_model_decoder else None)
        self.style_embedding = (StyleEmbedding(mel_dim, d_model_decoder)
                                if gst else None)
        self.spk_proj = (nn.Linear(spk_emb_dim, d_model_decoder)
                         if multi_speaker and spk_emb_vers == 2 else None)
        self.is_tacotron2 = decoder_type.lower() == "tacotron2"
        if self.is_tacotron2:
            self.decoder = Tacotron2Decoder(
                mel_dim, d_model_decoder, reduction_rate,
                dropout_prenet=dropout_prenet)
            self.out = self.stop_token = None
        else:
            self.decoder = Decoder(
                mel_dim, d_model_decoder, n_layer_decoder, n_head_decoder,
                ff_conv_kernel_size_decoder,
                concat_after=concat_after_decoder, dropout=dropout,
                dropout_prenet=dropout_prenet, use_flash=use_flash,
                spk_emb_dim=(per_layer if "decoder" in spk_emb_architecture
                             else None), output_type=output_type)
            self.out = nn.Linear(d_model_decoder, mel_dim * reduction_rate)
            self.stop_token = nn.Linear(d_model_decoder, reduction_rate)
        self.postnet = PostConvNet(d_model_decoder, mel_dim, reduction_rate,
                                   dropout_postnet, prev_version=False)

    def _autocast(self, x: torch.Tensor) -> AbstractContextManager:
        """bf16 autocast when ``amp``. While a CUDA graph is being captured
        (the decode loop's), autocast keeps no cache of cast weights: a
        cast made in the capture must be replayed, not reused."""
        capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=self.amp, cache_enabled=not capturing)

    @property
    def cache_dtype(self) -> torch.dtype:
        """The dtype of the decode loop's KV caches and fed-back frames:
        the projections' output dtype."""
        return torch.bfloat16 if self.amp else torch.float32

    def encode(self, src, src_mask, style_mel=None, spk_emb=None, *,
               collect_attn: bool = False,
               generator: Optional[torch.Generator] = None):
        """(e_outputs (B, L, d_model_decoder), encoder maps or None).
        With ``gst``, ``style_mel`` (B or 1, T, mel) gives the style
        vector added to every output; it must be given."""
        with self._autocast(src):
            e_outputs, attn_enc = self.encoder(
                src, src_mask, spk_emb, collect_attn=collect_attn,
                generator=generator)
            if self.linear is not None:
                e_outputs = self.linear(e_outputs)
            if self.style_embedding is not None:
                if style_mel is None:
                    raise ValueError(
                        "gst=True requires a style/reference mel")
                e_outputs = e_outputs + self.style_embedding(style_mel)
            if self.spk_proj is not None and spk_emb is not None:
                e_outputs = e_outputs + self.spk_proj(
                    l2_normalised(spk_emb.float()))[:, None, :]
        return e_outputs, attn_enc

    def speaker_biases(self, spk_emb):
        """The decoder layers' speaker biases of ``spk_emb`` (see
        ``Decoder.speaker_biases``), under the model's autocast."""
        if spk_emb is None or self.is_tacotron2:
            return None
        with self._autocast(spk_emb):
            return self.decoder.speaker_biases(spk_emb)

    def precompute_cross_kv(self, e_outputs):
        """Per-decoder-layer cross-attention (k, v), constant over a
        decode."""
        with self._autocast(e_outputs):
            return self.decoder.precompute_cross_kv(e_outputs)

    def decode_step(self, prev_frame, e_outputs, src_mask, caches,
                    cache_index, cross_kvs=None, spk_biases=None):
        """One AR step: (B, 1, mel) input frame -> (group (B, 1, mel*r),
        stop logits (B, 1, r)). ``caches``: per layer (k, v), each
        (B, H, max_steps, d_k), written in place at ``cache_index`` (an int
        or a 0-d integer tensor on the caches' device); the step attends to
        cache rows <= ``cache_index``. ``spk_biases``: the call's
        ``speaker_biases``."""
        max_steps = caches[0][0].shape[2]
        device = caches[0][0].device
        index = torch.as_tensor(cache_index, device=device).reshape(1)
        cols = torch.arange(max_steps, device=device)
        trg_mask = (cols <= index)[None, None, :].expand(
            prev_frame.shape[0], 1, max_steps)
        with self._autocast(prev_frame):
            d, _, _ = self.decoder(
                prev_frame, e_outputs, src_mask, trg_mask, spk_biases,
                caches=caches,
                cache_index=index, pos_offset=index, cross_kvs=cross_kvs)
            return self.out(d), self.stop_token(d)

    def apply_postnet(self, mel_pre):
        with self._autocast(mel_pre):
            return self.postnet(mel_pre)

    def forward(self, src, trg, src_mask, trg_mask, ref_mel=None, *,
                spk_emb=None, collect_attn: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> TransformerTTSOutput:
        """Teacher-forced forward. ``trg`` (B, t, mel) is the reduced
        decoder input (the go frame and every r-th frame), ``trg_mask``
        its (B, t, t) pad-and-causal mask; in train mode ``generator``
        seeds the kernel path's attention dropout. ``spk_emb`` (B,) ids or
        (B, 512) x-vectors for a multi-speaker model. With ``gst`` the
        style comes from ``ref_mel``, or in train mode without one from
        ``trg``. A Tacotron 2 decoder takes the full-rate target (B, T,
        mel), T a multiple of r, as ``trg`` and no ``trg_mask``, and
        returns its alignments as ``attn_dec_enc`` (B, T/r, L); in train
        mode ``generator`` also draws its prenet dropout and zoneout."""
        style_mel = (trg if self.style_embedding is not None
                     and self.training and ref_mel is None else ref_mel)
        e_outputs, attn_enc = self.encode(src, src_mask, style_mel, spk_emb,
                                          collect_attn=collect_attn,
                                          generator=generator)
        if self.is_tacotron2:
            with self._autocast(src):
                mel_pre, stop, attention = self.decoder(
                    trg, e_outputs, generator=generator)
                mel_post = self.postnet(mel_pre)
            return TransformerTTSOutput(
                mel_pre=mel_pre, mel_post=mel_post, stop_token=stop,
                attn_enc=attn_enc, attn_dec_dec=None,
                attn_dec_enc=attention)
        with self._autocast(src):
            d_output, attn_dd, attn_de = self.decoder(
                trg, e_outputs, src_mask, trg_mask,
                self.decoder.speaker_biases(spk_emb),
                collect_attn=collect_attn, generator=generator)
            mel_pre = self.out(d_output)
            stop = self.stop_token(d_output)
            mel_post = self.postnet(mel_pre)
        return TransformerTTSOutput(
            mel_pre=mel_pre, mel_post=mel_post, stop_token=stop,
            attn_enc=attn_enc, attn_dec_dec=attn_dd, attn_dec_enc=attn_de)


    def tacotron2_synthesize(self, src, src_mask, text_lengths=None,
                             spk_emb=None, ref_mel=None,
                             max_steps: int = 500, *, eager: bool = False):
        """Greedy synthesis through the Tacotron 2 decoder and the causal
        postnet -> (mel (B, max_steps*r, mel) post-postnet fp32, lengths
        (B,) in frames); the frames past a row's length are whatever the
        loop left there (``infer.synthesize.synthesize_tacotron2`` zeroes
        them). ``text_lengths`` (B,) masks the attention. On a CUDA device
        the loop replays CUDA graphs unless ``eager``."""
        from transformer_tts_tpu_torch.infer.synthesize import (
            tacotron2_decode)
        if not self.is_tacotron2:
            raise ValueError("tacotron2_synthesize requires "
                             "decoder_type='tacotron2'")
        e_outputs, _ = self.encode(src, src_mask, ref_mel, spk_emb)
        carry = tacotron2_decode(self, e_outputs, text_lengths, max_steps,
                                 eager=eager)
        b, r = src.shape[0], self.reduction_rate
        post = self.apply_postnet(carry["groups"].to(self.cache_dtype))
        mel = post.float().reshape(b, max_steps * r, self.mel_dim)
        return mel, carry["length"] * r


def check_supported(hp: HParams) -> None:
    """Raise ``ValueError`` for an encoder type that is not a stack and for
    a Tacotron 2 decoder with per-layer decoder speakers, which the JAX
    package cannot run."""
    check_stack_type("encoder_type", hp.encoder_type)
    check_speakers(hp)
    if (hp.decoder_type.lower() == "tacotron2" and hp.is_multi_speaker
            and hp.spk_emb_vers == 1 and "decoder" in spk_arch(hp)):
        raise ValueError(
            "decoder_type='tacotron2' with decoder speakers "
            "(spk_emb_architecture 'decoder', spk_emb_vers 1): the JAX "
            "package's Tacotron2Decoder adds speaker_L_l1_es's 4*d_model "
            "output to its 16*d_model gates and fails on the shapes, so "
            "there is no result to port; use spk_emb_vers 2 or encoder "
            "speakers")


def build_transformer_tts(hp: HParams, *, device="cuda",
                          seed: int = 0) -> TransformerTTS:
    """TransformerTTS from the hparams contract, with random weights from
    ``seed`` (as ``build_fastspeech2``), on ``device``."""
    check_supported(hp)
    model = TransformerTTS(
        vocab_size=hp.vocab_size, mel_dim=hp.mel_dim,
        d_model_encoder=hp.d_model_encoder,
        n_layer_encoder=hp.n_layer_encoder,
        n_head_encoder=hp.n_head_encoder,
        ff_conv_kernel_size_encoder=hp.ff_conv_kernel_size_encoder,
        concat_after_encoder=hp.concat_after_encoder,
        d_model_decoder=hp.d_model_decoder,
        n_layer_decoder=hp.n_layer_decoder,
        n_head_decoder=hp.n_head_decoder,
        ff_conv_kernel_size_decoder=hp.ff_conv_kernel_size_decoder,
        concat_after_decoder=hp.concat_after_decoder,
        encoder_type=hp.encoder_type, decoder_type=hp.decoder_type,
        reduction_rate=hp.reduction_rate,
        dropout=hp.dropout, dropout_prenet=hp.dropout_prenet,
        dropout_postnet=hp.dropout_postnet, gst=hp.gst,
        spk_emb_dim=hp.spk_emb_dim, spk_emb_architecture=spk_arch(hp),
        spk_emb_vers=hp.spk_emb_vers, multi_speaker=hp.is_multi_speaker,
        output_type=bool(hp.output_type), use_flash=hp.use_flash_attention,
        amp=hp.amp)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
