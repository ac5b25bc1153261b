"""Global Style Tokens (the port of transformer_tts_tpu/models/gst.py:29-90:
``ReferenceEncoder``, ``StyleTokenLayer`` and ``StyleEmbedding``).

* ``ReferenceEncoder``: six 3x3 stride-2 ``Conv2d`` without bias
  (channels 32, 32, 64, 64, 128, 128) over the (T, mel) "image", each
  followed by BatchNorm with flax's statistics (``FlaxBatchNorm2d``:
  biased variance over (B, H, W), padded frames included, momentum 0.99)
  and ReLU; then a 128-unit GRU over every frame, padding included, whose
  last step is the reference embedding. The conv output (B, C, T', H') is
  reshaped to (B, T', H'*C) with no permute, as the reference does: that
  interleaves channels and time steps in the GRU input, and checkpoints
  trained that way rely on it.
* The GRU keeps ``nn.GRU``'s parameters under the reference's names
  (``gru.weight_ih_l0`` ..., gates r, z, n along dim 0) and runs as a loop
  of its cell, as flax's ``nn.RNN`` scans its ``GRUCell``; the input
  projections of every step go in one product first. flax's cell has no
  hidden bias for r and z (the input bias holds their sum), so the r and
  z slices of ``bias_hh_l0`` get no gradient: a loaded value stays, and
  the sum trains as flax's one bias does.
* ``StyleTokenLayer``: 10 learnable tokens of ``d_model``, tanh-squashed,
  attended by a 4-head ``MultiHeadAttention`` whose query is the 128-d
  reference embedding, dropout 0.1; 10 keys take the masked path.
* ``StyleEmbedding``: (B, T, mel) reference mel -> (B, 1, d_model).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transformer_tts_tpu_torch.ops.attention import MultiHeadAttention
from transformer_tts_tpu_torch.ops.feedforward import FlaxBatchNorm2d

CNN_DIMS = (32, 32, 64, 64, 128, 128)
GRU_UNITS = 128
N_TOKENS = 10
TOKEN_HEADS = 4
TOKEN_DROPOUT = 0.1


def conv_out_size(n: int) -> int:
    """Length of one axis after the six stride-2 convs (3x3, padding 1)."""
    for _ in CNN_DIMS:
        n = (n - 1) // 2 + 1
    return n


class ReferenceEncoder(nn.Module):
    def __init__(self, mel_dim: int):
        super().__init__()
        chans = (1,) + CNN_DIMS
        self.conv_layers = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1,
                      bias=False) for i in range(len(CNN_DIMS)))
        self.norm = nn.ModuleList(
            FlaxBatchNorm2d(c, eps=1e-5, momentum=0.01) for c in CNN_DIMS)
        self.gru = nn.GRU(conv_out_size(mel_dim) * CNN_DIMS[-1], GRU_UNITS,
                          batch_first=True)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, mel) -> (B, 128), the GRU's state after the last frame."""
        x = mel[:, None]                                   # (B, 1, T, mel)
        for conv, norm in zip(self.conv_layers, self.norm):
            x = torch.relu(norm(conv(x)))
        b, c, t, h = x.shape
        x = x.reshape(b, t, h * c)      # no permute: the reference's order
        return gru_last(self.gru, x)


def gru_last(gru: nn.GRU, x: torch.Tensor) -> torch.Tensor:
    """The state of one-layer ``gru`` after the last step of (B, T, in)
    ``x``, from a zero state, by the loop of its cell (torch's GRU
    equations, gates r, z, n), the r and z hidden biases held."""
    units = gru.hidden_size
    b_hh = torch.cat([gru.bias_hh_l0[:2 * units].detach(),
                      gru.bias_hh_l0[2 * units:]])
    gi = F.linear(x, gru.weight_ih_l0, gru.bias_ih_l0)      # (B, T, 3H)
    h = x.new_zeros((x.shape[0], units), dtype=gi.dtype)
    for step in range(x.shape[1]):
        gh = F.linear(h, gru.weight_hh_l0, b_hh)
        i_r, i_z, i_n = gi[:, step].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
    return h


class StyleTokenLayer(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.embeddings = nn.Parameter(torch.zeros(N_TOKENS, d_model))
        self.attention = MultiHeadAttention(TOKEN_HEADS, d_model,
                                            TOKEN_DROPOUT, q_dim=GRU_UNITS)

    def forward(self, ref_embedding: torch.Tensor):
        """(B, 128) -> ((B, 1, d_model) style, (B, H, 1, n_tokens) probs)."""
        b = ref_embedding.shape[0]
        emb = torch.tanh(self.embeddings)[None].expand(b, -1, -1)
        return self.attention(ref_embedding[:, None, :], emb, emb, None,
                              collect_attn=True)


class StyleEmbedding(nn.Module):
    """(B, T, mel) reference mel -> (B, 1, d_model) style vector."""

    def __init__(self, mel_dim: int, d_model: int):
        super().__init__()
        self.reference_encoder = ReferenceEncoder(mel_dim)
        self.style_token_layer = StyleTokenLayer(d_model)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        style, _ = self.style_token_layer(self.reference_encoder(mel))
        return style
