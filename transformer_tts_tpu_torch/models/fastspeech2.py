"""FastSpeech 2, non-autoregressive text -> mel (the port of
transformer_tts_tpu/models/fastspeech2.py:39-256 with transformer or
conformer stacks, and of ``build_fastspeech2``,
transformer_tts_tpu/train/trainer.py:55-119).

Encoder over text -> VarianceAdaptor -> "decoder" (a second encoder stack
with a Linear input, over mel frames) -> PostConvNet (pre, post) or a plain
Linear head; ``encoder_type`` / ``decoder_type`` pick each stack. The
caller gives ``max_frames``, the mel length the variance adaptor expands
to; frames past the realized length are masked.

``use_sq_vae`` adds the SQ-VAE bottleneck after the encoder (the JAX
file's :172-184): the encoder output quantized by an ``SQEmbedding``
codebook (models/sq_vae.py) under the top-level ``log_var_q_scalar``,
stochastically at ``temperature`` in train mode (its ELBO loss and
perplexity in ``sq_vae_loss``/``sq_vae_perplexity``), by argmin in eval,
and added to the encoder output. The SQ-VAE FastSpeech 2 of
models/fastspeech2_sq.py quantizes inside its variance adaptor instead.

Conditioning (the JAX file's :141-222): ``spk_emb`` ((B,) speaker ids or
(B, 512) x-vectors) reaches the encoder's and the decoder's layers that
``spk_emb_architecture`` names (models/layers.py); ``middle`` adds
``spk_proj`` of the L2-normalised x-vector (the norm clipped at 1e-12)
to the encoder output, before the SQ-VAE; ``use_hop`` then adds
``hop_emb`` of the (B,) hop-size class (0, 1 = hop 256, 2 = hop 160);
``accent_emb`` gives the encoder per-phone accents; ``ctc_training``
taps the decoder stack (``ctc_logits`` (B, T, vocab)); ``use_pos`` and
``use_rnn_length`` go to the variance adaptor.

``amp`` runs the forward under bf16 autocast (the JAX package's
``dtype=bfloat16`` with fp32 parameters). In train mode the caller's
``generator`` seeds the kernel path's attention dropout, the scheduled
sampling and the SQ-VAE's Gumbel noise; the other dropouts draw from
torch's default generators. A stack type other than "transformer" or
"conformer" (the AR model's "tacotron2" among them) raises ``ValueError``;
the mel-to-mel post model raises ``NotImplementedError``: it comes with a
later slice. The discrete mode (``output_type``) changes no layer here:
the (B, T, mel_dim) head's halves are the two code streams' logits
(train/losses.softmax_output_loss).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams, spk_arch
from transformer_tts_tpu_torch.models.encoder import (
    ConformerEncoder, Encoder)
from transformer_tts_tpu_torch.models.layers import XVECTOR_DIM
from transformer_tts_tpu_torch.models.postnets import PostConvNet
from transformer_tts_tpu_torch.models.sq_vae import N_CODES, SQEmbedding
from transformer_tts_tpu_torch.models.variance_adaptor import (
    UniLSTM, VarianceAdaptor)

N_HOP_SIZES = 3


class FastSpeech2Output(NamedTuple):
    mel_pre: torch.Tensor                    # (B, T, mel)
    mel_post: Optional[torch.Tensor]         # (B, T, mel) or None
    log_duration: torch.Tensor               # (B, L)
    pitch: Optional[torch.Tensor]            # (B, T)
    energy: Optional[torch.Tensor]           # (B, T)
    mel_len: torch.Tensor                    # (B,)
    mel_pos: torch.Tensor                    # (B, T)
    mel_mask: torch.Tensor                   # (B, 1, T)
    variance_adaptor_output: torch.Tensor    # (B, T, D)
    text_dur_predicted: torch.Tensor         # (B, T, D)
    attn_enc: Optional[torch.Tensor]
    attn_dec: Optional[torch.Tensor]
    sq_vae_loss: Optional[torch.Tensor] = None
    sq_vae_perplexity: Optional[torch.Tensor] = None
    ctc_logits: Optional[torch.Tensor] = None   # (B, T, vocab)


def l2_normalised(spk_emb: torch.Tensor) -> torch.Tensor:
    """x / max(|x|, 1e-12) over the last axis."""
    return spk_emb / torch.linalg.vector_norm(
        spk_emb, dim=-1, keepdim=True).clamp(min=1e-12)


def _stack(encoder_type: str, **kw) -> nn.Module:
    if encoder_type.lower() == "conformer":
        kw.pop("concat_after")
        kw.pop("ff_kernel_size")
        return ConformerEncoder(**kw)
    return Encoder(**kw)


class FastSpeech2(nn.Module):
    def __init__(self, vocab_size: int = 152, mel_dim: int = 80,
                 d_model_encoder: int = 384, n_layer_encoder: int = 6,
                 n_head_encoder: int = 4, ff_conv_kernel_size_encoder: int = 5,
                 concat_after_encoder: bool = False,
                 d_model_decoder: int = 384, n_layer_decoder: int = 6,
                 n_head_decoder: int = 4, ff_conv_kernel_size_decoder: int = 1,
                 concat_after_decoder: bool = False,
                 encoder_type: str = "transformer",
                 decoder_type: str = "transformer", reduction_rate: int = 1,
                 postnet_pred: bool = True, dropout: float = 0.1,
                 dropout_postnet: float = 0.5,
                 dropout_variance_adaptor: float = 0.5, n_bins: int = 256,
                 f0_min: float = 71.0, f0_max: float = 795.8,
                 energy_min: float = 0.0, energy_max: float = 315.0,
                 log_offset: float = 1.0, pitch_pred: bool = True,
                 energy_pred: bool = True, f0_stats: Optional[tuple] = None,
                 energy_stats: Optional[tuple] = None,
                 p_scheduled_sampling: float = 0.0,
                 use_sq_vae: bool = False, use_pos: bool = False,
                 use_rnn_length: bool = False, accent_emb: bool = False,
                 spk_emb_dim: Optional[int] = None,
                 spk_emb_architecture: tuple = (), use_hop: bool = False,
                 ctc_training: bool = False,
                 use_flash: bool = False, amp: bool = False):
        super().__init__()
        self.log_offset = log_offset
        self.amp = amp
        self.spk_emb_architecture = tuple(spk_emb_architecture)
        self.encoder = _stack(
            encoder_type, vocab_size=vocab_size, d_model=d_model_encoder,
            n_layers=n_layer_encoder, heads=n_head_encoder,
            ff_kernel_size=ff_conv_kernel_size_encoder,
            concat_after=concat_after_encoder, dropout=dropout,
            embedding=True, use_flash=use_flash,
            spk_emb_dim=self._spk_dim("encoder", spk_emb_dim),
            accent_emb=accent_emb)
        self.spk_proj = (nn.Linear(spk_emb_dim, d_model_decoder)
                         if "middle" in self.spk_emb_architecture else None)
        self.codebook = None
        if use_sq_vae:
            self.log_var_q_scalar = nn.Parameter(
                torch.full((1,), math.log(10.0)))
            self.codebook = SQEmbedding(N_CODES, d_model_encoder)
        self.hop_emb = (nn.Embedding(N_HOP_SIZES, d_model_encoder)
                        if use_hop else None)
        self.variance_adaptor = VarianceAdaptor(
            d_model_encoder, n_bins, f0_min, f0_max, energy_min, energy_max,
            log_offset, pitch_pred, energy_pred, dropout_variance_adaptor,
            f0_stats, energy_stats, p_scheduled_sampling, use_pos,
            use_rnn_length)
        self.ctc_training = ctc_training
        self.decoder = _stack(
            decoder_type, vocab_size=d_model_encoder,
            d_model=d_model_decoder, n_layers=n_layer_decoder,
            heads=n_head_decoder, ff_kernel_size=ff_conv_kernel_size_decoder,
            concat_after=concat_after_decoder, dropout=dropout,
            embedding=False, use_flash=use_flash,
            spk_emb_dim=self._spk_dim("decoder", spk_emb_dim),
            ctc_out=ctc_training, ctc_classes=vocab_size)
        if postnet_pred:
            self.postnet = PostConvNet(d_model_decoder, mel_dim,
                                       reduction_rate, dropout_postnet)
        else:
            self.out = nn.Linear(d_model_decoder, mel_dim * reduction_rate)
        self.postnet_pred = postnet_pred

    def _spk_dim(self, place: str, spk_emb_dim):
        return spk_emb_dim if place in self.spk_emb_architecture else None

    def forward(self, text, src_mask, max_frames: int, d_target=None,
                p_target=None, e_target=None, mel_mask=None, *,
                spk_emb=None, accent=None, hop_size=None,
                collect_attn: bool = False, pitch_scale: float = 1.0,
                duration_scale: float = 1.0, temperature=None,
                generator: Optional[torch.Generator] = None
                ) -> FastSpeech2Output:
        """``text`` (B, L) ids, ``src_mask`` (B, 1, L) bool; the targets
        teacher-force durations (B, L), pitch and energy (B, T). A
        conditioned model takes ``spk_emb`` ((B,) ids or (B, 512)
        x-vectors), ``accent`` (B, L) and ``hop_size`` (B,). With
        ``use_sq_vae``, train mode takes the Gumbel-softmax
        ``temperature``."""
        sq_loss = sq_perplexity = ctc_logits = None
        with torch.autocast(text.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            e_outputs, attn_enc = self.encoder(text, src_mask, spk_emb,
                                               accent,
                                               collect_attn=collect_attn,
                                               generator=generator)
            if self.spk_proj is not None and spk_emb is not None:
                e_outputs = e_outputs + self.spk_proj(
                    l2_normalised(spk_emb.float()))[:, None, :]
            if self.codebook is not None:
                if self.training:
                    z, sq_loss, sq_perplexity, _ = self.codebook(
                        e_outputs, self.log_var_q_scalar, temperature,
                        generator=generator)
                else:
                    z, _ = self.codebook.encode(e_outputs,
                                                self.log_var_q_scalar)
                e_outputs = z + e_outputs
            if self.hop_emb is not None:
                e_outputs = e_outputs + self.hop_emb(hop_size)[:, None, :]
            va = self.variance_adaptor(
                e_outputs, src_mask, max_frames, d_target, p_target,
                e_target, mel_mask, pitch_scale=pitch_scale,
                duration_scale=duration_scale, generator=generator)
            dec = self.decoder(va.x, va.mel_mask, spk_emb,
                               collect_attn=collect_attn,
                               generator=generator)
            if self.ctc_training:
                d_output, attn_dec, ctc_logits = dec
            else:
                d_output, attn_dec = dec
            if self.postnet_pred:
                mel_pre, mel_post = self.postnet(d_output)
            else:
                mel_pre, mel_post = self.out(d_output), None
        return FastSpeech2Output(
            mel_pre=mel_pre, mel_post=mel_post, log_duration=va.log_duration,
            pitch=va.pitch, energy=va.energy, mel_len=va.mel_len,
            mel_pos=va.mel_pos, mel_mask=va.mel_mask,
            variance_adaptor_output=va.x,
            text_dur_predicted=va.text_dur_predicted,
            attn_enc=attn_enc, attn_dec=attn_dec, sq_vae_loss=sq_loss,
            sq_vae_perplexity=sq_perplexity, ctc_logits=ctc_logits)


def later_slice(feature: str, slice_name: str):
    """Raise for a feature that a later slice of the port brings."""
    raise NotImplementedError(
        f"{feature} is not ported yet: it comes with the {slice_name} "
        "slice of the PyTorch port (ROADMAP.md Queue 1)")


STACK_TYPES = ("transformer", "conformer")


def check_stack_type(key: str, value: str) -> None:
    """Raise ``ValueError`` for a stack type that is neither a transformer
    nor a conformer stack, which the JAX package builds as a transformer
    stack without a word."""
    if value.lower() not in STACK_TYPES:
        raise ValueError(
            f"{key}={value!r}: the stacks are 'transformer' or 'conformer' "
            "('tacotron2' is the AR model's decoder, model='Transformer'); "
            "the JAX package builds a transformer stack for any other name")


def _check_supported(hp: HParams) -> None:
    check_stack_type("encoder_type", hp.encoder_type)
    check_stack_type("decoder_type", hp.decoder_type)
    if hp.architecture == "text-mel-mel" or hp.version is not None:
        later_slice("the mel-to-mel post model (post_model)",
                    "mel-to-mel post-processing")
    check_speakers(hp)


def check_speakers(hp: HParams) -> None:
    """Raise for speaker hparams the model cannot run: a multi-speaker
    model without ``spk_emb_dim`` (the JAX model silently builds no
    speaker layer), or ``middle`` (an L2-normalised vector) with speaker
    ids (the JAX model fails on them)."""
    if hp.is_multi_speaker and hp.spk_emb_dim is None:
        raise ValueError("a multi-speaker model needs spk_emb_dim: 512 for "
                         "x-vectors, else the speaker-id table's rows")
    if "middle" in spk_arch(hp) and hp.spk_emb_dim != XVECTOR_DIM:
        raise ValueError("spk_emb_architecture 'middle' projects an "
                         f"x-vector: spk_emb_dim must be {XVECTOR_DIM}")


def _variance_stats(mean, std):
    if mean is None or std is None:
        return None
    return (float(mean), float(std))


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: Linear/Conv weights and the GRU's
    and LSTM's uniform in +-1/sqrt(fan_in) (torch's default range) with
    zero biases, embeddings and
    the SQ-VAE codebook N(0, 1), biases 0, norm scales and ``alpha`` 1,
    the conformer's ``pos_bias_u/v`` and the GST tokens Xavier-uniform as
    flax initialises them. BatchNorm running statistics stay (0, 1) and
    ``log_var_q_scalar`` log 10.
    """
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = module.weight
                bound = 1.0 / math.sqrt(w[0].numel())
                w.copy_(torch.rand(w.shape, generator=generator) * 2 * bound
                        - bound)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.GRU, UniLSTM)):
                for name, p in module.named_parameters():
                    if name.startswith("bias"):
                        p.zero_()
                    else:
                        bound = 1.0 / math.sqrt(p.shape[1])
                        p.copy_(torch.rand(p.shape, generator=generator)
                                * 2 * bound - bound)
            elif isinstance(module, nn.Embedding):
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=generator))
            elif isinstance(module, (nn.LayerNorm,
                                     nn.modules.batchnorm._BatchNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("pe.alpha"):
                p.fill_(1.0)
            elif name.endswith(("pos_bias_u", "pos_bias_v",
                                "style_token_layer.embeddings")):
                bound = math.sqrt(6.0 / sum(p.shape))
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)
            elif name.endswith("codebook.embedding"):
                p.copy_(torch.randn(p.shape, generator=generator))


def build_fastspeech2(hp: HParams, *, device="cuda",
                      seed: int = 0) -> FastSpeech2:
    """FastSpeech2 from the hparams contract, with random weights from
    ``seed``, on ``device``."""
    _check_supported(hp)
    model = FastSpeech2(
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
        reduction_rate=1 if hp.model.lower() == "fastspeech2"
        else hp.reduction_rate,
        postnet_pred=hp.postnet_pred, dropout=hp.dropout,
        dropout_postnet=hp.dropout_postnet,
        dropout_variance_adaptor=hp.dropout_variance_adaptor,
        n_bins=hp.nbins, f0_min=hp.f0_min, f0_max=hp.f0_max,
        energy_min=hp.energy_min, energy_max=hp.energy_max,
        log_offset=hp.log_offset, pitch_pred=hp.pitch_pred,
        energy_pred=hp.energy_pred,
        f0_stats=_variance_stats(hp.f0_mean, hp.f0_std),
        energy_stats=_variance_stats(hp.energy_mean, hp.energy_std),
        p_scheduled_sampling=hp.p_scheduled_sampling,
        use_sq_vae=hp.use_sq_vae, use_pos=hp.use_pos,
        use_rnn_length=hp.use_rnn_length, accent_emb=hp.accent_emb,
        spk_emb_dim=hp.spk_emb_dim, spk_emb_architecture=spk_arch(hp),
        use_hop=hp.use_hop, ctc_training=hp.CTC_training,
        use_flash=hp.use_flash_attention,
        amp=hp.amp)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
