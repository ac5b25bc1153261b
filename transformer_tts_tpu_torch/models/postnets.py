"""Post-networks (the port of transformer_tts_tpu/models/postnets.py:
``PostConvNet`` :36-75, ``Quantize`` :78-126, ``PostLowEnergyv1``
:129-152 and ``PostLowEnergyv2`` :155-232).

``prev_version=True`` (FastSpeech 2): Linear(d -> mel*r) gives the "pre"
mel; then 5 causal Conv1d(k=5), each left-padded by 4, with BatchNorm +
tanh + dropout between them, and a residual add gives the "post" mel; it
returns both. ``prev_version=False`` (the AR Transformer-TTS): no Linear,
the input is the pre mel (B, T, mel*r) and it returns the post mel only;
``identity_compat`` returns the input instead, the reference's no-op
postnet (its statistics still move in train mode, as in the JAX
package, which runs the stack and drops its output). BatchNorm follows
flax: eps 1e-5,
momentum 0.99 (torch ``momentum=0.01``); in eval mode it uses the running
statistics.

``Quantize`` is the EMA VQ codebook: the nearest of ``n_embed`` codes by
squared distance, a straight-through output (the input plus the detached
code minus input, so the gradient passes to the input unchanged) and the
commitment ``diff`` = mean (code - input)^2. ``mean=True`` first averages
(B, T, D) over T, every frame, padded ones included, as the JAX module
does. Its ``embed`` (D, N), ``cluster_size`` (N,) and ``embed_avg`` (D,
N) are fp32 buffers (the reference's names) that move only in train mode:
the cluster sizes and code sums decay by 0.99 towards the batch's, and
``embed`` becomes their Laplace-smoothed ratio. Under data parallelism
(``stats_group``, which parallel/mesh.set_norm_group sets) the batch's
counts and sums are summed over the group's ranks, so the EMA moves by
the global batch on every rank, as the JAX module's under pjit. The distances, the argmin
and the EMA run in fp32 with autocast off, and the output is fp32; the
JAX module takes the distances from a bf16 input under amp.

``PostLowEnergyv1`` and ``PostLowEnergyv2`` are the mel-to-mel students:
an encoder stack (models/encoder.py, a Linear input) over a (B, T, mel)
mel and an output Linear to ``out_size``. v2 fuses the per-frame phone
feature (``variance_adaptor_output`` or ``text_dur_predicted``, (B, T,
d_model): the student is as wide as the text encoder) by ``concat`` (mel, phone and a broadcast x-vector
concatenated as the stack's input) or by ``linear1`` of the mel plus,
with ``phone_embed``, ``linear2`` of the phone feature and, per
``spk_emb_postprocess_type``, ``linear_xvector`` of the (B,) speaker id
(an Embedding) or the (B, spk_emb_dim) x-vector (a Linear). ``vq_code``
adds the code of ``quantize_lmfb`` (20 codes) of the time-averaged
``vq_encoder_lmfb`` (a 1x1 conv of the mel) to every frame and returns
its ``diff``; ``post_conformer`` takes a conformer stack, and
``intermediate_layers_out`` the transformer stack's 80-wide taps after
the named layers. v2 returns (outputs, taps or None, diff or None). Each
student runs its forward under bf16 autocast when ``amp`` (inside the
integrate model, under the model's own). ``concat``
with speaker ids raises ``ValueError``: the JAX module broadcasts the
(B,) ids as (B, 1, D) and fails.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.encoder import (
    ConformerEncoder, Encoder)
from transformer_tts_tpu_torch.ops.feedforward import Conv1dBTC, batch_norm

CAUSAL = (4, 0)


class PostConvNet(nn.Module):
    def __init__(self, num_hidden: int, mel_dim: int,
                 reduction_rate: int = 1, dropout: float = 0.5,
                 prev_version: bool = True, identity_compat: bool = False):
        super().__init__()
        out_dim = mel_dim * reduction_rate
        self.prev_version = prev_version
        self.identity_compat = identity_compat
        if prev_version:
            self.out = nn.Linear(num_hidden, out_dim)
        self.conv1 = Conv1dBTC(out_dim, num_hidden, 5, CAUSAL)
        self.pre_batchnorm = batch_norm(num_hidden)
        self.conv_list = nn.ModuleList(
            Conv1dBTC(num_hidden, num_hidden, 5, CAUSAL) for _ in range(3))
        self.batch_norm_list = nn.ModuleList(
            batch_norm(num_hidden) for _ in range(3))
        self.conv2 = Conv1dBTC(num_hidden, out_dim, 5, CAUSAL)
        self.dropout = nn.Dropout(dropout)

    def _norm_act(self, bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
        h = bn(h.transpose(1, 2)).transpose(1, 2)
        return self.dropout(torch.tanh(h))

    def forward(self, x: torch.Tensor):
        """``prev_version``: (B, T, num_hidden) -> (mel_pre, mel_post), each
        (B, T, mel*r); else (B, T, mel*r) -> mel_post (B, T, mel*r)."""
        mel_pred = self.out(x) if self.prev_version else x
        h = self._norm_act(self.pre_batchnorm, self.conv1(mel_pred))
        for conv, bn in zip(self.conv_list, self.batch_norm_list):
            h = self._norm_act(bn, conv(h))
        post = mel_pred + self.conv2(h)
        if self.prev_version:
            return mel_pred, post
        return mel_pred if self.identity_compat else post


class Quantize(nn.Module):
    """The EMA VQ codebook (see the module docstring)."""

    def __init__(self, embed_dim: int, n_embed: int, decay: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.embed_dim = embed_dim
        self.n_embed = n_embed
        self.decay = decay
        self.eps = eps
        # the group whose batches move the EMA (None: this process's);
        # parallel/mesh.set_norm_group sets it
        self.stats_group = None
        embed = torch.randn(embed_dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def forward(self, x: torch.Tensor, *, mean: bool = False):
        """(B, T, D) -> (quantize fp32 of x's shape (B, D with ``mean``),
        diff (), codes (B*T,) or (B,))."""
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            if mean:
                x = x.mean(dim=1)
            flatten = x.reshape(-1, self.embed_dim)
            embed = self.embed
            dist = ((flatten ** 2).sum(-1, keepdim=True)
                    - 2.0 * flatten @ embed
                    + (embed ** 2).sum(0, keepdim=True))
            embed_ind = dist.argmin(dim=1)
            quantize = embed.t()[embed_ind].reshape(x.shape)
            if self.training:
                self._ema(flatten.detach(), embed_ind)
            diff = ((quantize.detach() - x) ** 2).mean()
            quantize = x + (quantize - x).detach()
        return quantize, diff, embed_ind

    @torch.no_grad()
    def _ema(self, flatten: torch.Tensor, embed_ind: torch.Tensor) -> None:
        onehot = nn.functional.one_hot(embed_ind, self.n_embed).float()
        # row 0 the codes' counts, the rest their sums of the inputs
        sums = torch.cat([onehot.sum(0)[None], flatten.t() @ onehot])
        if self.stats_group is not None:
            import torch.distributed as dist
            dist.all_reduce(sums, group=self.stats_group)
        self.cluster_size.mul_(self.decay).add_(
            sums[0], alpha=1 - self.decay)
        self.embed_avg.mul_(self.decay).add_(
            sums[1:], alpha=1 - self.decay)
        n = self.cluster_size.sum()
        cs = ((self.cluster_size + self.eps)
              / (n + self.n_embed * self.eps) * n)
        self.embed.copy_(self.embed_avg / cs[None, :])


VQ_CODES = 20


def student_autocast(amp: bool, x: torch.Tensor):
    """bf16 autocast for a student's forward when ``amp``, unless the
    caller's is already on (``torch.export`` refuses a nested one)."""
    if not amp or torch.is_autocast_enabled(x.device.type):
        return nullcontext()
    return torch.autocast(x.device.type, dtype=torch.bfloat16)


class PostLowEnergyv1(nn.Module):
    """Mel -> mel: an encoder stack over the mel and an output Linear."""

    def __init__(self, in_dim: int, out_size: int, d_model: int,
                 n_layers: int, heads: int, ff_kernel_size: int,
                 concat_after: bool = False, dropout: float = 0.1,
                 use_flash: bool = False, amp: bool = False):
        super().__init__()
        self.amp = amp
        self.encoder = Encoder(in_dim, d_model, n_layers, heads,
                               ff_kernel_size, concat_after, dropout,
                               embedding=False, use_flash=use_flash)
        self.out = nn.Linear(d_model, out_size)

    def forward(self, src, src_mask, *,
                generator: Optional[torch.Generator] = None):
        """``src`` (B, T, in_dim), ``src_mask`` (B, 1, T) -> (B, T,
        out_size)."""
        with student_autocast(self.amp, src):
            e_outputs, _ = self.encoder(src, src_mask, generator=generator)
            return self.out(e_outputs)


class PostLowEnergyv2(nn.Module):
    """Mel -> mel with the phone feature, speakers, the VQ code and the
    taps (see the module docstring)."""

    def __init__(self, in_dim: int, out_size: int, d_model: int,
                 n_layers: int, heads: int, ff_kernel_size: int,
                 concat_after: bool = False, dropout: float = 0.1,
                 phone_embed: bool = False, concat: bool = False,
                 spk_emb_postprocess_type: Optional[str] = None,
                 spk_emb_dim: Optional[int] = None,
                 num_speakers: Optional[int] = None, vq_code: bool = False,
                 post_conformer: bool = False,
                 intermediate_layers_out: Optional[tuple] = None,
                 use_flash: bool = False, amp: bool = False):
        super().__init__()
        self.amp = amp
        self.concat = concat
        self.phone_embed = phone_embed
        self.spk_type = spk_emb_postprocess_type
        if concat:
            if self.spk_type == "speaker_id":
                raise ValueError(
                    "concat=True with spk_emb_postprocess_type="
                    "'speaker_id': the JAX module broadcasts the (B,) "
                    "speaker ids as (B, 1, D) and fails; concat takes "
                    "x-vectors")
            enc_in_dim = in_dim + d_model + (
                spk_emb_dim if self.spk_type is not None else 0)
        else:
            enc_in_dim = d_model
            self.linear1 = nn.Linear(in_dim, d_model)
            if phone_embed:
                self.linear2 = nn.Linear(d_model, d_model)
            if self.spk_type == "speaker_id":
                self.linear_xvector = nn.Embedding(num_speakers, d_model)
            elif self.spk_type == "x_vector":
                self.linear_xvector = nn.Linear(spk_emb_dim, d_model)
        self.vq_code = vq_code
        if vq_code:
            self.vq_encoder_lmfb = Conv1dBTC(in_dim, enc_in_dim, 1)
            self.quantize_lmfb = Quantize(enc_in_dim, VQ_CODES)
        self.taps = bool(intermediate_layers_out) and not post_conformer
        if post_conformer:
            self.encoder = ConformerEncoder(
                enc_in_dim, d_model, n_layers, heads, dropout,
                embedding=False, use_flash=use_flash)
        else:
            self.encoder = Encoder(
                enc_in_dim, d_model, n_layers, heads, ff_kernel_size,
                concat_after, dropout, embedding=False, use_flash=use_flash,
                intermediate_layers_out=intermediate_layers_out)
        self.out = nn.Linear(d_model, out_size)

    def forward(self, src, src_mask, phone, spk_emb=None, *,
                generator: Optional[torch.Generator] = None):
        """``src`` (B, T, in_dim) mel, ``src_mask`` (B, 1, T), ``phone``
        (B, T, phone_dim), ``spk_emb`` (B,) ids or (B, spk_emb_dim)
        x-vectors -> (outputs (B, T, out_size), taps (list of (B, T, 80))
        or None, diff or None)."""
        with student_autocast(self.amp, src):
            if self.concat:
                pieces = [src, phone]
                if self.spk_type is not None:
                    pieces.append(spk_emb[:, None, :].expand(
                        -1, src.shape[1], -1).to(src.dtype))
                x = torch.cat([p.to(src.dtype) for p in pieces], dim=-1)
            else:
                x = self.linear1(src)
                if self.phone_embed:
                    x = x + self.linear2(phone)
                if self.spk_type is not None:
                    x = x + self.linear_xvector(spk_emb)[:, None, :]
            diff = None
            if self.vq_code:
                quant, diff, _ = self.quantize_lmfb(
                    self.vq_encoder_lmfb(src), mean=True)
                x = x + quant[:, None, :]
            enc = self.encoder(x, src_mask, generator=generator)
            taps = enc[2] if self.taps else None
            return self.out(enc[0]), taps, diff
