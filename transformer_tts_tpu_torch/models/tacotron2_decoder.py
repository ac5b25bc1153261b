"""The Tacotron 2 decoder of the AR Transformer-TTS (the port of
``Tacotron2Decoder``, transformer_tts_tpu/models/tacotron2_decoder.py,
selected by ``decoder_type = "tacotron2"``): a location-sensitive
attention over the encoder output and two zoneout-LSTM cells 4 x d_model
wide, one step per group of ``reduction_rate`` frames.

One step, from the carry (s1, c1, s2, c2, the previous frame, the
cumulative alignment):

* attention: a 31-tap bias-free conv (32 outputs, padding 15) over the
  cumulative alignment -> ``AttentionConvProj`` (128), plus
  ``AttentionEncoderProj`` of the encoder output and
  ``AttentionDecoderProj`` of s2 -> tanh -> ``AttentionSelfProj`` to fp32
  logits -> exp (the max subtracted in training, the text mask applied in
  synthesis) over its sum clamped at 1e-9 -> the context g;
* prenet: ``Prenet1``, ReLU, dropout, ``Prenet2``, ReLU, dropout (the
  dropouts ``dropout_prenet``, in training only);
* ``L_l1_ys(prenet) + L_l1_ss(s1) + L_l1_gs(g)`` -> cell 1;
  ``L_l2_is(s1) + L_l2_ss(s2)`` -> cell 2; each cell's gates i, f, g, o
  squashed with tanh(x/2)/2 + 1/2, and in training zoneout (rate
  ``zoneout_rate``) keeps the old c and h under one mask;
* ``FrameProj`` and ``TokenProj`` of [s2, g]: r frames and r stop logits.

Teacher forcing feeds zeros at step 0 and then the last frame of the
previous group. Synthesis feeds back the last predicted frame and stops
when ``step > 10`` and either the mean stop probability or the
alignment's last position (above 0.5, 0.85) says so, both read from batch
row 0, then runs a 4-step tail; every row shares that length (the JAX
package's rule, kept). ``AttentionEncoderProj`` of the encoder output is
the same at every step: each call computes it once, where the JAX
package recomputes it in every step.

The masks of the prenet dropout and of zoneout come from torch
generators (the caller's, or a device generator seeded from it), where
the JAX package draws them from its dropout key: the same distributions,
other bits. The JAX decoder adds a 4 x d_model speaker projection to the
16 x d_model gates and fails on the shapes, so the port builds no speaker
layer here (``models/transformer_tts.check_supported`` refuses one).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.sq_vae import device_generator

ATTENTION_DIM = 128
ATTENTION_CONV_CHANNELS = 32
ATTENTION_CONV_KERNEL = 31
ATTENTION_CONV_PADDING = 15             # the output keeps the input's length
STOP_AFTER_STEP = 10        # no stop before step 11
STOP_PROBABILITY = 0.5
STOP_ALIGNMENT = 0.85
END_TAIL = 4                # steps decoded after the stop rule fires


def gate_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """tanh(x/2)/2 + 1/2 (= sigmoid(x)), written as the reference does."""
    return torch.tanh(x * 0.5) * 0.5 + 0.5


class Tacotron2State(NamedTuple):
    s1: torch.Tensor                 # (B, 4d) fp32
    c1: torch.Tensor
    s2: torch.Tensor
    c2: torch.Tensor
    cumulate_alpha: torch.Tensor     # (B, L) fp32


class StepMasks(NamedTuple):
    """A training forward's random masks (float keep-scales for the
    prenet, bool keep-old for zoneout), or None where the rate is 0."""
    prenet1: Optional[torch.Tensor]
    prenet2: Optional[torch.Tensor]
    zoneout1: Optional[torch.Tensor]
    zoneout2: Optional[torch.Tensor]


class Tacotron2Decoder(nn.Module):
    def __init__(self, mel_dim: int, d_model: int, reduction_rate: int = 2,
                 dropout_prenet: float = 0.5, zoneout_rate: float = 0.1):
        super().__init__()
        # d_model is also the width of the encoder output and so of the
        # context g: TransformerTTS's ``linear`` brings it there
        d, d4 = d_model, 4 * d_model
        self.mel_dim = mel_dim
        self.d4 = d4
        self.reduction_rate = reduction_rate
        self.dropout_prenet = dropout_prenet
        self.zoneout_rate = zoneout_rate
        self.L_l1_ys = nn.Linear(d, 4 * d4, bias=False)
        self.L_l1_ss = nn.Linear(d4, 4 * d4, bias=False)
        self.L_l1_gs = nn.Linear(d, 4 * d4)
        self.L_l2_is = nn.Linear(d4, 4 * d4, bias=False)
        self.L_l2_ss = nn.Linear(d4, 4 * d4)
        self.FrameProj = nn.Linear(d4 + d, mel_dim * reduction_rate)
        self.TokenProj = nn.Linear(d4 + d, reduction_rate)
        self.Prenet1 = nn.Linear(mel_dim, d)
        self.Prenet2 = nn.Linear(d, d)
        self.AttentionConv = nn.Conv1d(1, ATTENTION_CONV_CHANNELS,
                                       ATTENTION_CONV_KERNEL,
                                       padding=ATTENTION_CONV_PADDING,
                                       bias=False)
        self.AttentionConvProj = nn.Linear(ATTENTION_CONV_CHANNELS,
                                           ATTENTION_DIM, bias=False)
        self.AttentionEncoderProj = nn.Linear(d, ATTENTION_DIM)
        self.AttentionDecoderProj = nn.Linear(d4, ATTENTION_DIM, bias=False)
        self.AttentionSelfProj = nn.Linear(ATTENTION_DIM, 1, bias=False)

    # -- one step --------------------------------------------------------
    def init_state(self, b: int, input_len: int, device) -> Tacotron2State:
        z = torch.zeros(b, self.d4, device=device)
        return Tacotron2State(z, z, z, z,
                              torch.zeros(b, input_len, device=device))

    def _attention(self, s2, cumulate_alpha, e_outputs, enc_proj, e_mask,
                   subtract_max: bool):
        conv = self.AttentionConv(
            cumulate_alpha[:, None, :].to(enc_proj.dtype))
        conv = self.AttentionConvProj(conv.transpose(1, 2))
        e = torch.tanh(self.AttentionDecoderProj(s2)[:, None, :] + enc_proj
                       + conv)
        logits = self.AttentionSelfProj(e)[..., 0].float()
        if subtract_max:
            logits = logits - logits.max(dim=1, keepdim=True).values
        expl = torch.exp(logits)
        if e_mask is not None:
            expl = expl * e_mask
        alpha = expl / expl.sum(dim=1, keepdim=True).clamp(min=1e-9)
        g = torch.bmm(alpha.to(e_outputs.dtype)[:, None, :],
                      e_outputs)[:, 0]
        return alpha, g

    @staticmethod
    def _cell(rec, s_prev, c_prev, keep_old):
        rec = rec.float()
        # the three gates squashed in one pass over all four (the cell
        # gate's share of it unused): fewer launches a step
        i, f, _, o = gate_sigmoid(rec).chunk(4, dim=-1)
        c = f * c_prev + i * torch.tanh(rec.chunk(4, dim=-1)[2])
        h = o * torch.tanh(c)
        if keep_old is not None:
            c = torch.where(keep_old, c_prev, c)
            h = torch.where(keep_old, s_prev, h)
        return h, c

    def prenet(self, frames, keep1=None, keep2=None):
        """``Prenet1``, ReLU, ``Prenet2``, ReLU over frames of any leading
        shape, each ReLU's output times its dropout keep-scale when
        given."""
        pre = torch.relu(self.Prenet1(frames))
        if keep1 is not None:
            pre = pre * keep1
        pre = torch.relu(self.Prenet2(pre))
        return pre if keep2 is None else pre * keep2

    def recur(self, state: Tacotron2State, ys, e_outputs, enc_proj,
              e_mask=None, *, subtract_max: bool, zoneout1=None,
              zoneout2=None):
        """The attention and both cells of one step, ``ys`` being
        ``L_l1_ys`` of the step's prenet output -> (new state, the
        context g, alpha (B, L) fp32)."""
        alpha, g = self._attention(state.s2, state.cumulate_alpha,
                                   e_outputs, enc_proj, e_mask,
                                   subtract_max)
        rec = ys + self.L_l1_ss(state.s1) + self.L_l1_gs(g)
        s1, c1 = self._cell(rec, state.s1, state.c1, zoneout1)
        rec = self.L_l2_is(s1) + self.L_l2_ss(state.s2)
        s2, c2 = self._cell(rec, state.s2, state.c2, zoneout2)
        return (Tacotron2State(s1, c1, s2, c2, state.cumulate_alpha + alpha),
                g, alpha)

    def heads(self, s2, g):
        """``FrameProj`` and ``TokenProj`` of [s2, g]: the r frames (…,
        mel*r) and the r stop logits."""
        proj_input = torch.cat([s2, g.to(s2.dtype)], dim=-1)
        return self.FrameProj(proj_input), self.TokenProj(proj_input)

    def step(self, state: Tacotron2State, prev_frame, e_outputs, enc_proj,
             e_mask=None, *, subtract_max: bool):
        """One decoder step without dropout or zoneout (synthesis) ->
        (new state, frames (B, mel*r), stop logits (B, r), alpha (B, L)
        fp32)."""
        ys = self.L_l1_ys(self.prenet(prev_frame))
        new, g, alpha = self.recur(state, ys, e_outputs, enc_proj, e_mask,
                                   subtract_max=subtract_max)
        frames, stop = self.heads(new.s2, g)
        return new, frames, stop, alpha

    def train_masks(self, steps: int, b: int, device,
                    generator: Optional[torch.Generator] = None):
        """A training forward's random masks, drawn in bulk on ``device``:
        the prenet's two keep-scales (B, steps, d) (1/(1-p) kept, 0
        dropped) and zoneout's two keep-old masks (steps, B, 4d) (True
        with probability ``zoneout_rate``), one per cell and step, shared
        by c and h; None where the rate is 0."""
        gen = device_generator(generator, device)
        d, d4 = self.Prenet2.out_features, self.d4
        p, z = self.dropout_prenet, self.zoneout_rate

        def prenet():
            if p <= 0:
                return None
            keep = torch.rand(b, steps, d, device=device, generator=gen) >= p
            return keep.float() / (1.0 - p)

        def zoneout():
            if z <= 0:
                return None
            return torch.rand(steps, b, d4, device=device, generator=gen) < z

        return StepMasks(prenet(), prenet(), zoneout(), zoneout())

    # -- teacher forcing -------------------------------------------------
    def forward(self, meltarget, e_outputs, *,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced forward over the full-rate target ``meltarget``
        (B, T, mel), T a multiple of r -> (frames (B, T/r, mel*r), stop
        logits (B, T/r, r), alignments (B, T/r, L) fp32). In train mode
        the prenet dropout and zoneout draw from ``generator``. The
        teacher frames are known in advance, so the prenet and
        ``L_l1_ys`` run over all steps at once before the loop, and the
        heads over all steps after it; the loop runs the attention and the
        cells."""
        b, t, _ = meltarget.shape
        r = self.reduction_rate
        steps = t // r
        device = e_outputs.device
        state = self.init_state(b, e_outputs.shape[1], device)
        fed = torch.cat([meltarget.new_zeros(b, 1, self.mel_dim),
                         meltarget[:, r - 1::r][:, :steps - 1]], dim=1)
        masks = (self.train_masks(steps, b, device, generator)
                 if self.training else StepMasks(None, None, None, None))
        # unbound, so that the backward stacks the steps' gradients once
        # rather than adding each into a zero tensor of the whole size
        ys = self.L_l1_ys(self.prenet(fed, masks.prenet1,
                                      masks.prenet2)).unbind(1)
        enc_proj = self.AttentionEncoderProj(e_outputs)
        s2s, gs, alphas = [], [], []
        for i in range(steps):
            state, g, a = self.recur(
                state, ys[i], e_outputs, enc_proj, subtract_max=True,
                zoneout1=None if masks.zoneout1 is None
                else masks.zoneout1[i],
                zoneout2=None if masks.zoneout2 is None
                else masks.zoneout2[i])
            s2s.append(state.s2)
            gs.append(g)
            alphas.append(a)
        frames, stops = self.heads(torch.stack(s2s, 1), torch.stack(gs, 1))
        return frames, stops, torch.stack(alphas, 1)

    # -- synthesis -------------------------------------------------------
    def synthesis_carry(self, b: int, input_len: int, max_steps: int,
                        device) -> Dict[str, torch.Tensor]:
        """The synthesis loop's carry, every entry a tensor the steps
        update in place: the state, the fed-back frame, the fp32 frame
        groups (B, max_steps, mel*r), the step, the stop tail, ``done``
        and the length in groups (``max_steps`` until the stop)."""
        st = self.init_state(b, input_len, device)
        carry = {k: v.clone() for k, v in st._asdict().items()}
        carry.update(
            prev=torch.zeros(b, self.mel_dim, device=device),
            groups=torch.zeros(b, max_steps,
                               self.mel_dim * self.reduction_rate,
                               device=device),
            step=torch.zeros((), dtype=torch.long, device=device),
            end_tail=torch.full((), END_TAIL, dtype=torch.long,
                                device=device),
            done=torch.zeros((), dtype=torch.bool, device=device),
            length=torch.full((b,), max_steps, dtype=torch.long,
                              device=device))
        return carry

    def synthesis_step(self, c: Dict[str, torch.Tensor], e_outputs,
                       enc_proj, e_mask) -> None:
        """One synthesis step on the carry ``c``, in place (fixed
        addresses, so a captured step replays): the group at ``step``,
        the stop rule on row 0, the tail, ``done``, and the length fixed
        at the step that ends the tail. A step after ``done`` changes
        neither ``length`` nor ``done``."""
        max_steps = c["groups"].shape[1]
        state = Tacotron2State(c["s1"], c["c1"], c["s2"], c["c2"],
                               c["cumulate_alpha"])
        new, frames, stop, alpha = self.step(
            state, c["prev"], e_outputs, enc_proj, e_mask,
            subtract_max=False)
        for key, value in new._asdict().items():
            c[key].copy_(value)
        step = c["step"]
        c["groups"].index_copy_(1, step.reshape(1), frames.float()[:, None])
        c["prev"].copy_(frames[:, -self.mel_dim:])
        p_stop = torch.sigmoid(stop.float()).mean(dim=-1)
        end_now = (step > STOP_AFTER_STEP) & (
            (p_stop[0] > STOP_PROBABILITY) | (alpha[0, -1] > STOP_ALIGNMENT))
        tail = c["end_tail"]
        tail.copy_(torch.where(end_now | (tail < END_TAIL), tail - 1, tail))
        c["done"].copy_(tail < 1)
        c["length"].copy_(torch.where(
            c["done"] & (c["length"] == max_steps), step + 1, c["length"]))
        step.add_(1)


def text_mask(text_lengths: Optional[torch.Tensor],
              input_len: int) -> Optional[torch.Tensor]:
    """(B, L) fp32, 1 on each row's first ``text_lengths`` positions."""
    if text_lengths is None:
        return None
    ids = torch.arange(input_len, device=text_lengths.device)[None, :]
    return (ids < text_lengths[:, None]).float()

