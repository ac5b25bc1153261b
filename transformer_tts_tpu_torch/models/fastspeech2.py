"""FastSpeech 2, non-autoregressive text -> mel (the port of
transformer_tts_tpu/models/fastspeech2.py:39-327 with transformer or
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
sampling, the SQ-VAE's Gumbel noise and the semantic mask's draws; the
other dropouts draw from torch's default generators. A stack type other
than "transformer" or "conformer" (the AR model's "tacotron2" among them)
raises ``ValueError``. The discrete mode (``output_type``) changes no
layer here:
the (B, T, mel_dim) head's halves are the two code streams' logits
(train/losses.softmax_output_loss).

The text-mel-mel integrate model (``enable_post_model``, the JAX file's
:117-122, :259-298; ``build_fastspeech2`` builds it for
``architecture = "text-mel-mel"``) attaches ``post_model``, a
``PostLowEnergyv2`` of ``post_model_cfg`` over the mel_post (mel_pre
without the postnet) and the variance adaptor's output, and returns its
output in ``post_output``. In train mode with duration targets,
``semantic_mask`` first fills the frames of random interior phones with
1e-4 in that mel (and the phone feature with ``semantic_mask_phone``),
and ``mask_frames`` (B, T, 1) says which. Versions 8 and 9 add
``post_model_replace_mask``, a second student on the masked input (the
first reads mel_pre and the unmasked phone feature at 8, the masked ones
at 9), and return both outputs as a pair; version 10 with taps returns
(output, its first tap). ``spk_emb_post`` conditions the student.
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
from transformer_tts_tpu_torch.models.postnets import (
    PostConvNet, PostLowEnergyv1, PostLowEnergyv2, Quantize)
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
    post_output: Optional[object] = None        # a tensor or a pair
    mask_frames: Optional[torch.Tensor] = None  # (B, T, 1) bool


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
                 use_flash: bool = False, amp: bool = False,
                 enable_post_model: bool = False,
                 post_model_cfg: Optional[dict] = None,
                 version: Optional[int] = None, semantic_mask: bool = False,
                 semantic_mask_phone: bool = False,
                 mask_probability: float = 0.06):
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
        self.version = version
        self.semantic_mask = semantic_mask
        self.semantic_mask_phone = semantic_mask_phone
        self.mask_probability = mask_probability
        self.post_model = self.post_model_replace_mask = None
        if enable_post_model:
            cfg = dict(post_model_cfg or {}, in_dim=mel_dim, amp=amp)
            self.post_model = PostLowEnergyv2(**cfg)
            if version in (8, 9):
                self.post_model_replace_mask = PostLowEnergyv2(**cfg)

    def _spk_dim(self, place: str, spk_emb_dim):
        return spk_emb_dim if place in self.spk_emb_architecture else None

    def forward(self, text, src_mask, max_frames: int, d_target=None,
                p_target=None, e_target=None, mel_mask=None, *,
                spk_emb=None, accent=None, hop_size=None,
                spk_emb_post=None,
                collect_attn: bool = False, pitch_scale: float = 1.0,
                duration_scale: float = 1.0, temperature=None,
                generator: Optional[torch.Generator] = None
                ) -> FastSpeech2Output:
        """``text`` (B, L) ids, ``src_mask`` (B, 1, L) bool; the targets
        teacher-force durations (B, L), pitch and energy (B, T). A
        conditioned model takes ``spk_emb`` ((B,) ids or (B, 512)
        x-vectors), ``accent`` (B, L) and ``hop_size`` (B,), the
        integrate model's student ``spk_emb_post``. With
        ``use_sq_vae``, train mode takes the Gumbel-softmax
        ``temperature``."""
        sq_loss = sq_perplexity = ctc_logits = None
        post_output = mask_frames = None
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
            if self.post_model is not None:
                post_output, mask_frames = self._run_post_model(
                    mel_pre, mel_post, va, d_target, spk_emb_post, generator)
        return FastSpeech2Output(
            mel_pre=mel_pre, mel_post=mel_post, log_duration=va.log_duration,
            pitch=va.pitch, energy=va.energy, mel_len=va.mel_len,
            mel_pos=va.mel_pos, mel_mask=va.mel_mask,
            variance_adaptor_output=va.x,
            text_dur_predicted=va.text_dur_predicted,
            attn_enc=attn_enc, attn_dec=attn_dec, sq_vae_loss=sq_loss,
            sq_vae_perplexity=sq_perplexity, ctc_logits=ctc_logits,
            post_output=post_output, mask_frames=mask_frames)

    def _run_post_model(self, mel_pre, mel_post, va, d_target,
                        spk_emb_post, generator):
        """(post_output, mask_frames) of the integrate model (see the
        module docstring)."""
        input_meltomel = mel_post if self.postnet_pred else mel_pre
        phone_feature = va.x
        mask_frames = None
        if self.semantic_mask and self.training and d_target is not None:
            input_meltomel, masked_phone, mask_frames = semantic_mask(
                input_meltomel, va.x if self.semantic_mask_phone else None,
                d_target, self.mask_probability, generator=generator)
            if masked_phone is not None:
                phone_feature = masked_phone
        if self.version in (8, 9):
            first_in = mel_pre if self.version == 8 else input_meltomel
            first_phone = va.x if self.version == 8 else phone_feature
            out_a = self.post_model(first_in, va.mel_mask, first_phone,
                                    spk_emb_post, generator=generator)[0]
            out_b = self.post_model_replace_mask(
                input_meltomel, va.mel_mask, phone_feature, spk_emb_post,
                generator=generator)[0]
            return (out_a, out_b), mask_frames
        out, taps, _ = self.post_model(input_meltomel, va.mel_mask,
                                       phone_feature, spk_emb_post,
                                       generator=generator)
        if self.version == 10 and taps:
            return (out, taps[0]), mask_frames
        return out, mask_frames


SEMANTIC_MASK_FILL = 1e-4


def mask_uniform(b: int, n_phones: int, device,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The semantic mask's (B, n_phones) uniform draws in [0, 1), from the
    CPU ``generator``, then moved to ``device``."""
    return torch.rand((b, n_phones), generator=generator).to(
        device, non_blocking=True)


def semantic_mask(mel, phone_feature, d_target, p: float, *,
                  uniform: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  eps: float = SEMANTIC_MASK_FILL):
    """Phone-span masking (the JAX file's :301-327): each interior phone
    (not the first or last column) is masked where its (B, n_phones)
    ``uniform`` draw (default ``mask_uniform`` from ``generator``) is
    below ``p``, and every frame of a masked phone's duration span, inside
    the row's total, is filled with ``eps`` in ``mel`` (B, T, C) and
    ``phone_feature``. -> (mel, phone_feature or None, mask_frames (B, T,
    1) bool)."""
    b, n_frames = mel.shape[:2]
    n_phones = d_target.shape[1]
    if uniform is None:
        uniform = mask_uniform(b, n_phones, mel.device, generator)
    sample = uniform.to(mel.device) < p
    interior = torch.ones(n_phones, dtype=torch.bool, device=mel.device)
    interior[0] = interior[-1] = False
    sample = sample & interior
    ends = torch.cumsum(d_target.long(), dim=1)
    t = torch.arange(n_frames, device=mel.device)
    phone_idx = torch.searchsorted(ends, t.expand(b, n_frames).contiguous(),
                                   right=True).clamp(max=n_phones - 1)
    mask_frames = (torch.gather(sample, 1, phone_idx)
                   & (t[None, :] < ends[:, -1:]))
    fill = mask_frames[:, :, None]
    mel = torch.where(fill, torch.full((), eps, dtype=mel.dtype,
                                       device=mel.device), mel)
    if phone_feature is not None:
        phone_feature = torch.where(
            fill, torch.full((), eps, dtype=phone_feature.dtype,
                             device=mel.device), phone_feature)
    return mel, phone_feature, fill


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


# flax's ``variance_scaling(..., "truncated_normal")`` draws from N(0, 1)
# cut at +-2 and divides the target std by this, the std of that cut normal
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: std 1/sqrt(fan_in) after a normal cut at
    +-2 of its own std, which is 1/sqrt(fan_in) / TRUNCATED_STD."""
    std = 1.0 / math.sqrt(fan_in) / TRUNCATED_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def orthogonal_gates_(w: torch.Tensor, gates: int,
                      generator: torch.Generator) -> None:
    """flax's ``orthogonal`` recurrent kernel of each gate: ``w``
    (gates * H, H) in torch's layout, one random orthogonal (H, H) block
    per gate (the transpose of flax's (in, out) kernel, orthogonal
    alike)."""
    for block in w.chunk(gates, dim=0):
        nn.init.orthogonal_(block, generator=generator)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, drawn as flax's ``init`` draws
    the JAX package's modules: Linear and Conv kernels LeCun truncated
    normal (``lecun_normal_``, fan_in the inputs times the kernel's
    taps), embeddings N(0, 1/d), the GRU's and LSTM's input kernels LeCun
    truncated normal per gate and their hidden kernels orthogonal per
    gate, every bias 0, norm scales and ``alpha`` 1, the conformer's
    ``pos_bias_u/v`` and the GST tokens Xavier-uniform, the SQ-VAE
    codebook N(0, 1). BatchNorm running statistics stay (0, 1) and
    ``log_var_q_scalar`` log 10. The EMA VQ's ``embed`` is N(0, 1), its
    ``embed_avg`` a copy and its cluster sizes 0.
    """
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Quantize):
                module.embed.copy_(torch.randn(module.embed.shape,
                                               generator=generator))
                module.embed_avg.copy_(module.embed)
                module.cluster_size.zero_()
            elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(),
                              generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.GRU, UniLSTM)):
                gates = 3 if isinstance(module, nn.GRU) else 4
                for name, p in module.named_parameters():
                    if name.startswith("bias"):
                        p.zero_()
                    elif name.startswith("weight_hh"):
                        orthogonal_gates_(p, gates, generator)
                    else:
                        lecun_normal_(p, p.shape[1], generator)
            elif isinstance(module, nn.Embedding):
                d = module.weight.shape[1]
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=generator)
                                    / math.sqrt(d))
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


def post_model_config(hp: HParams) -> dict:
    """The student's ``PostLowEnergyv2`` arguments from the hparams (the
    JAX ``build_fastspeech2``'s ``post_cfg``), its input width aside."""
    return dict(
        out_size=hp.mel_dim_post, d_model=hp.d_model_encoder,
        n_layers=hp.n_layer_post_model, heads=hp.n_head_encoder,
        ff_kernel_size=hp.ff_conv_kernel_size_post,
        concat_after=hp.concat_after_post, dropout=hp.dropout,
        phone_embed=hp.phone_embed, concat=hp.concat,
        spk_emb_postprocess_type=hp.spk_emb_postprocess_type,
        spk_emb_dim=hp.spk_emb_dim_postprocess,
        num_speakers=hp.num_speakers, vq_code=hp.vq_code,
        post_conformer=hp.post_conformer,
        intermediate_layers_out=(tuple(hp.intermediate_layers_out)
                                 if hp.intermediate_layers_out else None),
        use_flash=hp.use_flash_attention)


def build_post_model(hp: HParams, *, device="cuda", seed: int = 0
                     ) -> nn.Module:
    """The mel-to-mel student of ``hp.version`` (the JAX
    train/post_trainers.py:41-63): ``PostLowEnergyv1`` at versions 1 and
    5, else ``PostLowEnergyv2``, over ``hp.mel_dim`` mels, with random
    weights from
    ``seed``, on ``device``."""
    cfg = post_model_config(hp)
    if hp.version in (1, 5):
        model = PostLowEnergyv1(
            hp.mel_dim, cfg["out_size"], cfg["d_model"], cfg["n_layers"],
            cfg["heads"], cfg["ff_kernel_size"], cfg["concat_after"],
            cfg["dropout"], use_flash=cfg["use_flash"], amp=hp.amp)
    else:
        model = PostLowEnergyv2(in_dim=hp.mel_dim, amp=hp.amp, **cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def build_fastspeech2(hp: HParams, *, device="cuda", seed: int = 0
                      ) -> FastSpeech2:
    """FastSpeech2 from the hparams contract, with random weights from
    ``seed``, on ``device``; with the integrate model's post model when
    ``architecture`` is "text-mel-mel"."""
    _check_supported(hp)
    enable_post_model = hp.architecture == "text-mel-mel"
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
        amp=hp.amp, enable_post_model=enable_post_model,
        post_model_cfg=post_model_config(hp) if enable_post_model else None,
        version=hp.version, semantic_mask=hp.semantic_mask,
        semantic_mask_phone=hp.semantic_mask_phone,
        mask_probability=hp.mask_probability)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
