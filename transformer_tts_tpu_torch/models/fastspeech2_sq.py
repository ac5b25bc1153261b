"""SQ-VAE FastSpeech 2, the duration-unsupervised variant (the port of
``SQVarianceAdaptor`` and ``SQFastSpeech2``,
transformer_tts_tpu/models/fastspeech2_sq.py:41-220, and of
``build_sq_fastspeech2``, transformer_tts_tpu/train/trainer.py:435-464).

The variance adaptor quantizes the encoder output through an
``SQEmbedding`` codebook (models/sq_vae.py) *before* the duration
predictor:

  z = quantize(x)            (Gumbel-softmax at train, argmin at eval)
  log_d = duration_predictor(z)
  with a duration target: x expanded by it;
  without one: x and z both expanded by the predicted durations, x + z.

The pitch and energy predictors read the expanded x, and their embeddings
take the targets when given, else the predictions, in raw units (no
standardization, no scheduled sampling, no perturbation scales). The
``mel_mask`` the caller passes is used as it is; without one it comes
from the expanded length. ``log_var_q_scalar`` (initialised to log 10)
and ``codebook.embedding`` sit in ``variance_adaptor``, under the
reference's names. The encoder and decoder are the FastSpeech 2 stacks,
so the decoder's self-attention takes the same kernels (K1 at eval, K1-d
and K2 in training). ``amp`` and ``generator`` as in models/fastspeech2.py.

Speakers and accents, as the JAX model reads them (its :150-200):
``spk_emb`` ((B,) ids or (B, 512) x-vectors) reaches the ``SpeakerBias``
of the encoder's and the decoder's layers where ``spk_emb_architecture``
names the stack, and ``accent_emb`` gives the encoder its per-phone
``acc_embed``. The JAX model reads no other conditioning option:
``build_sq_fastspeech2`` raises ``ValueError`` for ``middle``,
``use_hop``, ``CTC_training``, ``use_pos`` and ``use_rnn_length``,
which it would silently ignore.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams, spk_arch
from transformer_tts_tpu_torch.models.fastspeech2 import (
    FastSpeech2Output, _check_supported, _stack, init_parameters)
from transformer_tts_tpu_torch.models.postnets import PostConvNet
from transformer_tts_tpu_torch.models.sq_vae import N_CODES, SQEmbedding
from transformer_tts_tpu_torch.models.variance_adaptor import (
    VariancePredictor, energy_bins, pitch_bins)
from transformer_tts_tpu_torch.ops.length_regulator import (
    durations_from_log, length_regulate)


class SQVarianceAdaptorOutput(NamedTuple):
    x: torch.Tensor                      # (B, T, D) + pitch/energy emb
    log_duration: torch.Tensor           # (B, L)
    pitch: Optional[torch.Tensor]        # (B, T)
    energy: Optional[torch.Tensor]       # (B, T)
    mel_len: torch.Tensor                # (B,)
    mel_pos: torch.Tensor                # (B, T)
    mel_mask: torch.Tensor               # (B, 1, T)
    text_dur_predicted: torch.Tensor     # expanded features pre-pitch/energy
    sq_vae_loss: Optional[torch.Tensor]
    sq_vae_perplexity: Optional[torch.Tensor]


class SQVarianceAdaptor(nn.Module):
    def __init__(self, d_model: int, n_bins: int = 256, f0_min: float = 71.0,
                 f0_max: float = 795.8, energy_min: float = 0.0,
                 energy_max: float = 315.0, log_offset: float = 1.0,
                 pitch_pred: bool = True, energy_pred: bool = True,
                 dropout: float = 0.5):
        super().__init__()
        self.d_model = d_model
        self.log_offset = log_offset
        self.log_var_q_scalar = nn.Parameter(
            torch.full((1,), math.log(10.0)))
        self.codebook = SQEmbedding(N_CODES, d_model)
        self.duration_predictor = VariancePredictor(d_model, dropout=dropout)
        self.pitch_predictor = self.energy_predictor = None
        if pitch_pred:
            self.pitch_predictor = VariancePredictor(d_model,
                                                     dropout=dropout)
            self.pitch_embedding = nn.Embedding(n_bins, d_model)
            self.register_buffer("pitch_bins",
                                 pitch_bins(f0_min, f0_max, n_bins),
                                 persistent=False)
        if energy_pred:
            self.energy_predictor = VariancePredictor(d_model,
                                                      dropout=dropout)
            self.energy_embedding = nn.Embedding(n_bins, d_model)
            self.register_buffer("energy_bins",
                                 energy_bins(energy_min, energy_max, n_bins),
                                 persistent=False)

    def forward(self, x, src_mask, max_frames: int, duration_target=None,
                pitch_target=None, energy_target=None, mel_mask=None, *,
                temperature=None, generator: Optional[torch.Generator] = None
                ) -> SQVarianceAdaptorOutput:
        z = x[..., : self.d_model]
        sq_loss = sq_perplexity = None
        if self.training:
            z, sq_loss, sq_perplexity, _ = self.codebook(
                z, self.log_var_q_scalar, temperature, generator=generator)
        else:
            z, _ = self.codebook.encode(z, self.log_var_q_scalar)
        log_d = self.duration_predictor(z, src_mask)

        if duration_target is not None:
            x, mel_len, mel_pos = length_regulate(x, duration_target.long(),
                                                  max_frames)
        else:
            durations = durations_from_log(log_d.float(), self.log_offset)
            durations = torch.where(src_mask[:, 0, :], durations,
                                    torch.zeros_like(durations))
            x, mel_len, mel_pos = length_regulate(x, durations, max_frames)
            z_exp, _, _ = length_regulate(z, durations, max_frames)
            x = x + z_exp
        if mel_mask is None:
            mel_mask = (mel_pos != 0)[:, None, :]

        pitch = energy = None
        out = x
        if self.pitch_predictor is not None:
            pitch = self.pitch_predictor(x, mel_mask)
            src = pitch_target if pitch_target is not None else pitch
            out = out + self.pitch_embedding(
                torch.bucketize(src.float(), self.pitch_bins))
        if self.energy_predictor is not None:
            energy = self.energy_predictor(x, mel_mask)
            src = energy_target if energy_target is not None else energy
            out = out + self.energy_embedding(
                torch.bucketize(src.float(), self.energy_bins))
        return SQVarianceAdaptorOutput(
            x=out, log_duration=log_d, pitch=pitch, energy=energy,
            mel_len=mel_len, mel_pos=mel_pos, mel_mask=mel_mask,
            text_dur_predicted=x, sq_vae_loss=sq_loss,
            sq_vae_perplexity=sq_perplexity)


class SQFastSpeech2(nn.Module):
    def __init__(self, vocab_size: int = 152, mel_dim: int = 80,
                 d_model_encoder: int = 384, n_layer_encoder: int = 6,
                 n_head_encoder: int = 4, ff_conv_kernel_size_encoder: int = 5,
                 concat_after_encoder: bool = False,
                 d_model_decoder: int = 384, n_layer_decoder: int = 6,
                 n_head_decoder: int = 4, ff_conv_kernel_size_decoder: int = 1,
                 concat_after_decoder: bool = False,
                 encoder_type: str = "transformer",
                 decoder_type: str = "transformer",
                 postnet_pred: bool = True, dropout: float = 0.1,
                 dropout_postnet: float = 0.5,
                 dropout_variance_adaptor: float = 0.5, n_bins: int = 256,
                 f0_min: float = 71.0, f0_max: float = 795.8,
                 energy_min: float = 0.0, energy_max: float = 315.0,
                 log_offset: float = 1.0, pitch_pred: bool = True,
                 energy_pred: bool = True, accent_emb: bool = False,
                 spk_emb_dim: Optional[int] = None,
                 spk_emb_architecture: tuple = (), use_flash: bool = False,
                 amp: bool = False):
        super().__init__()
        self.log_offset = log_offset
        self.amp = amp
        self.encoder = _stack(
            encoder_type, vocab_size=vocab_size, d_model=d_model_encoder,
            n_layers=n_layer_encoder, heads=n_head_encoder,
            ff_kernel_size=ff_conv_kernel_size_encoder,
            concat_after=concat_after_encoder, dropout=dropout,
            embedding=True, use_flash=use_flash,
            spk_emb_dim=(spk_emb_dim if "encoder" in spk_emb_architecture
                         else None),
            accent_emb=accent_emb)
        self.variance_adaptor = SQVarianceAdaptor(
            d_model_encoder, n_bins, f0_min, f0_max, energy_min, energy_max,
            log_offset, pitch_pred, energy_pred, dropout_variance_adaptor)
        self.decoder = _stack(
            decoder_type, vocab_size=d_model_encoder,
            d_model=d_model_decoder, n_layers=n_layer_decoder,
            heads=n_head_decoder, ff_kernel_size=ff_conv_kernel_size_decoder,
            concat_after=concat_after_decoder, dropout=dropout,
            embedding=False, use_flash=use_flash,
            spk_emb_dim=(spk_emb_dim if "decoder" in spk_emb_architecture
                         else None))
        if postnet_pred:
            self.postnet = PostConvNet(d_model_decoder, mel_dim, 1,
                                       dropout_postnet)
        else:
            self.out = nn.Linear(d_model_decoder, mel_dim)
        self.postnet_pred = postnet_pred

    def forward(self, text, src_mask, max_frames: int, d_target=None,
                p_target=None, e_target=None, mel_mask=None, *,
                spk_emb=None, accent=None,
                temperature=None, collect_attn: bool = False,
                generator: Optional[torch.Generator] = None,
                pitch_scale: float = 1.0, duration_scale: float = 1.0
                ) -> FastSpeech2Output:
        """As ``FastSpeech2.forward``; train mode takes the Gumbel-softmax
        ``temperature``; ``spk_emb`` and ``accent`` as the stacks take
        them.
        ``pitch_scale``/``duration_scale`` must stay 1: the SQ adaptor has
        no perturbation."""
        if pitch_scale != 1.0 or duration_scale != 1.0:
            raise ValueError("the SQ-VAE variance adaptor takes no pitch or "
                             "duration scale")
        with torch.autocast(text.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            e_outputs, attn_enc = self.encoder(text, src_mask, spk_emb,
                                               accent,
                                               collect_attn=collect_attn,
                                               generator=generator)
            va = self.variance_adaptor(
                e_outputs, src_mask, max_frames, d_target, p_target,
                e_target, mel_mask, temperature=temperature,
                generator=generator)
            d_output, attn_dec = self.decoder(va.x, va.mel_mask, spk_emb,
                                              collect_attn=collect_attn,
                                              generator=generator)
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
            attn_enc=attn_enc, attn_dec=attn_dec,
            sq_vae_loss=va.sq_vae_loss,
            sq_vae_perplexity=va.sq_vae_perplexity)


def check_sq_options(hp: HParams) -> None:
    """Raise ``ValueError`` for the conditioning options that the JAX
    package's ``SQFastSpeech2`` silently ignores."""
    ignored = [name for name, on in (
        ("spk_emb_architecture 'middle'", "middle" in spk_arch(hp)),
        ("use_hop", hp.use_hop), ("CTC_training", hp.CTC_training),
        ("use_pos", hp.use_pos), ("use_rnn_length", hp.use_rnn_length))
        if on]
    if ignored:
        raise ValueError(
            f"{', '.join(ignored)}: the JAX package's SQ-VAE FastSpeech 2 "
            "ignores these options (it reads speakers in the encoder and "
            "decoder layers and accents only), so the port refuses them")


def build_sq_fastspeech2(hp: HParams, *, device="cuda",
                         seed: int = 0) -> SQFastSpeech2:
    """SQFastSpeech2 from the hparams contract, with random weights from
    ``seed``, on ``device``."""
    _check_supported(hp)
    check_sq_options(hp)
    model = SQFastSpeech2(
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
        postnet_pred=hp.postnet_pred, dropout=hp.dropout,
        dropout_postnet=hp.dropout_postnet,
        dropout_variance_adaptor=hp.dropout_variance_adaptor,
        n_bins=hp.nbins, f0_min=hp.f0_min, f0_max=hp.f0_max,
        energy_min=hp.energy_min, energy_max=hp.energy_max,
        log_offset=hp.log_offset, pitch_pred=hp.pitch_pred,
        energy_pred=hp.energy_pred, accent_emb=hp.accent_emb,
        spk_emb_dim=hp.spk_emb_dim, spk_emb_architecture=spk_arch(hp),
        use_flash=hp.use_flash_attention, amp=hp.amp)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
