"""Carry the JAX package's FastSpeech 2 and AR Transformer-TTS weights into
the port.

``state_dict_from_flax(params, batch_stats, hp)`` takes the flax parameter
and batch-statistics trees (nested dicts of numpy arrays) and returns the
port's ``state_dict``, under the reference torch repo's parameter names.
It inverts transformer_tts_tpu/compat/torch_import.py:60-194, for
conformer stacks ``convert_conformer_encoder_state_dict`` (:351-410) and,
for the AR model (``hp.model`` not a NAR family),
``convert_transformer_state_dict`` (:300-348):

  flax Dense kernel (in, out)        -> Linear.weight (out, in)
  flax Conv kernel (k, in, out)      -> Conv1d.weight (out, in, k)
  flax Embed embedding               -> Embedding.weight
  flax LayerNorm/BatchNorm scale/bias -> weight/bias
  flax batch_stats mean/var          -> running_mean/running_var
  flax depthwise Conv kernel (k, 1, d) -> Conv1d(groups=d).weight (d, 1, k)
  flax Conv kernel (3, 3, in, out)   -> Conv2d.weight (out, in, 3, 3)
  flax GRUCell ir/iz/in, hr/hz/hn    -> GRU weight_ih_l0/weight_hh_l0 (r, z,
                                        n along dim 0), bias_ih_l0 = [ir, iz,
                                        in] biases, bias_hh_l0 = [0, 0, hn]
  flax OptimizedLSTMCell ii/if/ig/io, hi/hf/hg/ho
                                     -> UniLSTM weight_ih_l0/weight_hh_l0 (i,
                                        f, g, o along dim 0), bias_hh_l0 =
                                        the h* biases (the i* have none)

Speaker conditioning (``SpeakerBias``'s ``multi_emb`` and
``speaker_L_l1_es``, the conformer layers' ``multi_emb``, ``spk_proj``),
``hop_emb``, the encoders' ``acc_embed``, the decoder's ``ctc_linear``
and the variance adaptor's ``pos.alpha`` and ``rnn_length`` are written
where the hparams build them (the JAX package's own torch converter maps
none of them).

The Tacotron 2 decoder (``decoder_type = "tacotron2"``) inverts
``_map_tacotron2_decoder`` (:282-297): every flax Dense under its own
name, ``AttentionConv``'s (31, 1, 32) kernel as Conv1d's (32, 1, 31). In
the discrete mode (``output_type``) the AR prenet's fc1 is an ``Embed``
table.

``lm_state_dict_from_flax`` carries ``LSTMLanguageModel``
(models/lm.py), each ``OptimizedLSTMCell_<i>`` into ``lstms.<i>`` as for
``rnn_length``; ``encoder_prenet_state_dict_from_flax``,
``aligner_state_dict_from_flax`` and
``encoder_postprocessing_state_dict_from_flax`` carry the three modules
that no model builds (models/prenets.py, models/variance_adaptor.py,
models/encoder.py).

The GST style embedding (``hp.gst``) inverts ``convert_style_embedding``
(:247-264) and ``_map_gru`` (:220-244); the SQ-VAE codebook and
``log_var_q_scalar`` (``SQFastSpeech2``, or ``use_sq_vae``) invert
``convert_sq_fastspeech2_state_dict`` (:455-511).

The mel-to-mel line: ``post_state_dict_from_flax(params, batch_stats,
vq_stats, hp)`` carries a PostLowEnergy student of ``hp.version`` (the
JAX train/post_trainers.build_post_model's), and
``state_dict_from_flax`` of ``architecture = "text-mel-mel"`` hparams
carries the integrate model's ``post_model`` (and, at versions 8 and 9,
``post_model_replace_mask``), given the ``vq_stats`` tree: the EMA VQ's
``quantize_lmfb`` ``embed``, ``cluster_size`` and ``embed_avg`` become
the port's buffers of those names, the encoder's taps
``intermediate_<i>`` its ``intermediate.<i>``.

``vocoder_state_dict_from_flax(params, hp)`` does the same for the JAX
package's vocoder generator (HiFi-GAN, subpixel or transposed, and the
iSTFT vocoder) and, with ``discriminator=True``, its MPD + MSD, under the
flax module names; flax ``WeightNorm`` scales become weight norm's ``g``.

``flax_layouts(hp)`` and ``vocoder_flax_layouts(params, hp)`` give, for
each parameter those write, the flax leaves it holds (``QLeaf``): their
rank in flax and the port dim of their last axis, which the weight-only
int8 of infer/quantize.py reduces along as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from transformer_tts_tpu_torch.config import (
    is_nar_model, is_sq_model, spk_arch)
from transformer_tts_tpu_torch.models.gst import CNN_DIMS
from transformer_tts_tpu_torch.models.layers import XVECTOR_DIM


class QLeaf(NamedTuple):
    """One flax parameter leaf inside a port parameter: the leaf's rank in
    flax, the port dim that holds the leaf's last axis (the axis the JAX
    package's int8 scale runs along), and into how many equal row blocks
    of the port tensor's dim 0 its tensor is cut (a GRU gate is one of 3;
    1 is the whole tensor)."""
    ndim: int
    axis: int
    blocks: int = 1


def _get(tree: Mapping, path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


class _Writer:
    """Writes the port ``state_dict`` (``out``) from flax trees and, for
    each parameter, its flax leaves (``layouts``). With ``params`` None it
    reads no tree: every leaf is a dummy of its rank, and only the
    layouts mean anything."""

    def __init__(self, params: Optional[Mapping],
                 batch_stats: Optional[Mapping],
                 vq_stats: Optional[Mapping] = None):
        self.params = params
        self.batch_stats = batch_stats
        self.vq_stats = vq_stats
        self.out: Dict[str, torch.Tensor] = {}
        self.layouts: Dict[str, List[QLeaf]] = {}

    def _param(self, path, ndim: int) -> np.ndarray:
        if self.params is None:
            return np.zeros((1,) * ndim, np.float32)
        return _get(self.params, path)

    def _stat(self, path) -> np.ndarray:
        if self.batch_stats is None:
            return np.zeros((1,), np.float32)
        return _get(self.batch_stats, path)

    def _put(self, name: str, array: np.ndarray, *leaves: QLeaf):
        self.out[name] = torch.from_numpy(np.ascontiguousarray(array))
        if leaves:
            self.layouts[name] = list(leaves)

    def vector(self, path, name):
        """A 1-D flax leaf, the same in the port."""
        self._put(name, self._param(path, 1), QLeaf(1, 0))

    def linear(self, path, name, bias=True):
        self._put(f"{name}.weight", self._param(path + ("kernel",), 2).T,
                  QLeaf(2, 0))
        if bias:
            self.vector(path + ("bias",), f"{name}.bias")

    def conv1d(self, path, name, bias=True):
        self._put(f"{name}.weight", self._param(path + ("kernel",), 3)
                  .transpose(2, 1, 0), QLeaf(3, 0))
        if bias:
            self.vector(path + ("bias",), f"{name}.bias")

    def table(self, path, name):
        """A 2-D flax leaf kept as it is: its last axis is the port's
        dim 1 (an ``Embed`` table's features, not its rows)."""
        self._put(name, self._param(path, 2), QLeaf(2, 1))

    def embed(self, path, name):
        self.table(path + ("embedding",), f"{name}.weight")

    def layer_norm(self, path, name):
        self.vector(path + ("scale",), f"{name}.weight")
        self.vector(path + ("bias",), f"{name}.bias")

    def batch_norm(self, path, name):
        self.layer_norm(path, name)
        self._put(f"{name}.running_mean", self._stat(path + ("mean",)))
        self._put(f"{name}.running_var", self._stat(path + ("var",)))
        self.out[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def speaker_embedding(self, path, name, spk_emb_dim):
        """``multi_emb``: a Dense of x-vectors (dim 512) or an Embed of
        speaker ids."""
        if spk_emb_dim == XVECTOR_DIM:
            self.linear(path, name)
        else:
            self.embed(path, name)

    def speaker_bias(self, path, name, spk_emb_dim):
        self.speaker_embedding(path + ("multi_emb",), f"{name}.multi_emb",
                               spk_emb_dim)
        self.linear(path + ("speaker_L_l1_es",), f"{name}.speaker_L_l1_es",
                    bias=False)

    def stack_extras(self, prefix: str, cond: dict):
        p = tuple(prefix.split("."))
        if cond.get("accent_emb"):
            self.embed(p + ("acc_embed",), f"{prefix}.acc_embed")
        if cond.get("ctc_out"):
            self.linear(p + ("ctc_linear",), f"{prefix}.ctc_linear")
        for i in cond.get("taps") or ():
            if i < cond["n_layers"]:
                self.linear(p + (f"intermediate_{i}",),
                            f"{prefix}.intermediate.{i}")

    def encoder_stack(self, prefix: str, n_layers: int, embedding: bool,
                      cond: dict):
        p = tuple(prefix.split("."))
        if embedding:
            self.embed(p + ("embed",), f"{prefix}.embed")
        else:
            self.linear(p + ("embed",), f"{prefix}.embed")
        self.vector(p + ("pe", "alpha"), f"{prefix}.pe.alpha")
        spk = cond.get("spk_emb_dim")
        for i in range(n_layers):
            lp, ln = p + (f"layers_{i}",), f"{prefix}.layers.{i}"
            self.layer_norm(lp + ("norm_1",), f"{ln}.norm_1")
            self.layer_norm(lp + ("norm_2",), f"{ln}.norm_2")
            self.mha(lp + ("attn",), f"{ln}.attn")
            self.conv1d(lp + ("ff", "f_1"), f"{ln}.ff.f_1")
            self.conv1d(lp + ("ff", "f_2"), f"{ln}.ff.f_2")
            self.layer_norm(lp + ("ff", "layer_norm"), f"{ln}.ff.layer_norm")
            if spk is not None:
                self.speaker_bias(lp + ("spk_bias",), f"{ln}.spk_bias", spk)
        self.layer_norm(p + ("norm",), f"{prefix}.norm")
        self.stack_extras(prefix, cond)

    def conformer_stack(self, prefix: str, n_layers: int, embedding: bool,
                        cond: dict):
        p = tuple(prefix.split("."))
        if embedding:
            self.embed(p + ("embed",), f"{prefix}.embed")
        else:
            self.linear(p + ("embed",), f"{prefix}.embed")
        spk = cond.get("spk_emb_dim")
        for i in range(n_layers):
            lp, ln = p + (f"layers_{i}",), f"{prefix}.layers.{i}"
            if spk is not None:
                self.speaker_embedding(lp + ("multi_emb",),
                                       f"{ln}.multi_emb", spk)
            for ff in ("ff_1", "ff_2"):
                self.layer_norm(lp + (ff, "layer_norm"),
                                f"{ln}.{ff}.layer_norm")
                self.linear(lp + (ff, "linear1"), f"{ln}.{ff}.linear1")
                self.linear(lp + (ff, "linear2"), f"{ln}.{ff}.linear2")
            self.layer_norm(lp + ("norm",), f"{ln}.norm")
            a, an = lp + ("attn",), f"{ln}.attn"
            for part in ("q_linear", "k_linear", "v_linear", "out"):
                self.linear(a + (part,), f"{an}.{part}")
            self.linear(a + ("linear_pos",), f"{an}.linear_pos", bias=False)
            for bias in ("pos_bias_u", "pos_bias_v"):
                self.table(a + (bias,), f"{an}.{bias}")
            c, cn = lp + ("conv_module",), f"{ln}.conv_module"
            self.layer_norm(c + ("layer_norm",), f"{cn}.layer_norm")
            self.conv1d(c + ("pointwise_conv1",), f"{cn}.pointwise_conv1")
            self.conv1d(c + ("depthwise_conv",), f"{cn}.depth_conv1.conv")
            self.conv1d(c + ("depthwise_out",), f"{cn}.depth_conv1.conv_out")
            self.batch_norm(c + ("batch_norm",), f"{cn}.batch_norm")
            self.conv1d(c + ("pointwise_conv2",), f"{cn}.pointwise_conv2")
        self.layer_norm(p + ("norm",), f"{prefix}.norm")
        self.stack_extras(prefix, cond)

    def stack(self, stack_type: str, prefix: str, n_layers: int,
              embedding: bool, **cond):
        """One encoder stack; ``cond``: its ``spk_emb_dim`` (per-layer
        speakers), ``accent_emb``, ``ctc_out`` and ``taps`` (the
        transformer stack's intermediate layers)."""
        writer = (self.conformer_stack if stack_type.lower() == "conformer"
                  else self.encoder_stack)
        writer(prefix, n_layers, embedding, dict(cond, n_layers=n_layers))

    def vq_buffer(self, path, name):
        """An EMA VQ buffer from the ``vq_stats`` tree (no int8 leaf)."""
        value = (np.zeros((1,), np.float32) if self.vq_stats is None
                 else _get(self.vq_stats, path))
        self._put(name, value)

    def post_low_energy(self, prefix: str, hp, v1: bool):
        """A PostLowEnergy student under ``prefix`` ("" for the student
        alone): v1 (``v1``) or v2 of ``hp``'s options."""
        p = tuple(prefix.split(".")) if prefix else ()
        n = f"{prefix}." if prefix else ""
        if not v1:
            if not hp.concat:
                self.linear(p + ("linear1",), f"{n}linear1")
                if hp.phone_embed:
                    self.linear(p + ("linear2",), f"{n}linear2")
                if hp.spk_emb_postprocess_type == "speaker_id":
                    self.embed(p + ("linear_xvector",), f"{n}linear_xvector")
                elif hp.spk_emb_postprocess_type == "x_vector":
                    self.linear(p + ("linear_xvector",),
                                f"{n}linear_xvector")
            if hp.vq_code:
                self.conv1d(p + ("vq_encoder_lmfb",), f"{n}vq_encoder_lmfb")
                for buf in ("embed", "cluster_size", "embed_avg"):
                    self.vq_buffer(p + ("quantize_lmfb", buf),
                                   f"{n}quantize_lmfb.{buf}")
        conformer = hp.post_conformer and not v1
        self.stack("conformer" if conformer else "transformer",
                   f"{n}encoder", hp.n_layer_post_model, embedding=False,
                   taps=None if (v1 or conformer)
                   else hp.intermediate_layers_out)
        self.linear(p + ("out",), f"{n}out")

    def mha(self, path, name):
        for part in ("q_linear", "k_linear", "v_linear", "out"):
            self.linear(path + (part,), f"{name}.{part}")

    def style_embedding(self):
        p, n = ("style_embedding",), "style_embedding"
        re_p, re_n = p + ("reference_encoder",), f"{n}.reference_encoder"
        for i in range(len(CNN_DIMS)):
            self._put(f"{re_n}.conv_layers.{i}.weight",
                      self._param(re_p + (f"conv_{i}", "kernel"), 4)
                      .transpose(3, 2, 0, 1), QLeaf(4, 0))
            self.batch_norm(re_p + (f"norm_{i}",), f"{re_n}.norm.{i}")
        self.gru(re_p + ("gru_cell",), f"{re_n}.gru")
        st_p, st_n = p + ("style_token_layer",), f"{n}.style_token_layer"
        self.table(st_p + ("embeddings",), f"{st_n}.embeddings")
        self.mha(st_p + ("attention",), f"{st_n}.attention")

    def gru(self, cell, name):
        """flax ``GRUCell`` -> ``nn.GRU``: r/z's hidden biases are folded
        into ``ir``/``iz``, so ``bias_hh_l0`` is [0, 0, hn.bias]."""
        gate = {g: self._param(cell + (g, "kernel"), 2).T
                for g in ("ir", "iz", "in", "hr", "hz", "hn")}
        bias = {g: self._param(cell + (g, "bias"), 1)
                for g in ("ir", "iz", "in", "hn")}
        zero = np.zeros_like(bias["hn"])
        three = [QLeaf(2, 0, blocks=3)] * 3
        self._put(f"{name}.weight_ih_l0",
                  np.concatenate([gate["ir"], gate["iz"], gate["in"]]),
                  *three)
        self._put(f"{name}.weight_hh_l0",
                  np.concatenate([gate["hr"], gate["hz"], gate["hn"]]),
                  *three)
        self._put(f"{name}.bias_ih_l0",
                  np.concatenate([bias["ir"], bias["iz"], bias["in"]]),
                  *[QLeaf(1, 0, blocks=3)] * 3)
        # r's and z's slices are no flax leaf
        self._put(f"{name}.bias_hh_l0",
                  np.concatenate([zero, zero, bias["hn"]]),
                  QLeaf(1, 0, blocks=3))

    def lstm(self, cell, name):
        """flax ``OptimizedLSTMCell`` -> ``UniLSTM``: the gates i, f, g, o
        stacked along dim 0; the input kernels have no bias."""
        ih = [self._param(cell + (f"i{g}", "kernel"), 2).T for g in "ifgo"]
        hh = [self._param(cell + (f"h{g}", "kernel"), 2).T for g in "ifgo"]
        bias = [self._param(cell + (f"h{g}", "bias"), 1) for g in "ifgo"]
        four = [QLeaf(2, 0, blocks=4)] * 4
        self._put(f"{name}.weight_ih_l0", np.concatenate(ih), *four)
        self._put(f"{name}.weight_hh_l0", np.concatenate(hh), *four)
        self._put(f"{name}.bias_hh_l0", np.concatenate(bias),
                  *[QLeaf(1, 0, blocks=4)] * 4)

    def sq_codebook(self, path, prefix):
        self.vector(path + ("log_var_q_scalar",),
                    f"{prefix}log_var_q_scalar")
        self.table(path + ("codebook", "embedding"),
                   f"{prefix}codebook.embedding")

    def ar_decoder(self, n_layers: int, spk_emb_dim, output_type=False):
        p = ("decoder",)
        fc1 = self.embed if output_type else self.linear
        fc1(p + ("decoder_prenet", "fc1"),
            "decoder.decoder_prenet.layer.fc1")
        self.linear(p + ("decoder_prenet", "fc2"),
                    "decoder.decoder_prenet.layer.fc2")
        self.vector(p + ("pe", "alpha"), "decoder.pe.alpha")
        for i in range(n_layers):
            lp, ln = p + (f"layers_{i}",), f"decoder.layers.{i}"
            for norm in ("norm_1", "norm_2", "norm_3"):
                self.layer_norm(lp + (norm,), f"{ln}.{norm}")
            self.mha(lp + ("attn_1",), f"{ln}.attn_1")
            self.mha(lp + ("attn_2",), f"{ln}.attn_2")
            self.conv1d(lp + ("ff", "f_1"), f"{ln}.ff.f_1")
            self.conv1d(lp + ("ff", "f_2"), f"{ln}.ff.f_2")
            self.layer_norm(lp + ("ff", "layer_norm"), f"{ln}.ff.layer_norm")
            if spk_emb_dim is not None:
                self.speaker_bias(lp + ("spk_bias",), f"{ln}.spk_bias",
                                  spk_emb_dim)
        self.layer_norm(p + ("norm",), "decoder.norm")

    def tacotron2_decoder(self):
        p = ("decoder",)
        for name, bias in TACOTRON2_LINEARS:
            self.linear(p + (name,), f"decoder.{name}", bias=bias)
        self.conv1d(p + ("AttentionConv",), "decoder.AttentionConv",
                    bias=False)

    def postnet_convs(self):
        pn = ("postnet",)
        self.conv1d(pn + ("conv1",), "postnet.conv1")
        self.conv1d(pn + ("conv2",), "postnet.conv2")
        self.batch_norm(pn + ("pre_batchnorm",), "postnet.pre_batchnorm")
        for i in range(3):
            self.conv1d(pn + (f"conv_list_{i}",), f"postnet.conv_list.{i}")
            self.batch_norm(pn + (f"batch_norm_list_{i}",),
                            f"postnet.batch_norm_list.{i}")

    def variance_predictor(self, path, name):
        self.conv1d(path + ("conv1",), f"{name}.conv1")
        self.conv1d(path + ("conv2",), f"{name}.conv2")
        self.layer_norm(path + ("layer_norm1",), f"{name}.layer_norm1")
        self.layer_norm(path + ("layer_norm2",), f"{name}.layer_norm2")
        self.linear(path + ("linear_layer",), f"{name}.linear_layer")


# the Tacotron 2 decoder's Dense layers (the reference's names) and
# whether each has a bias
TACOTRON2_LINEARS = (
    ("L_l1_ys", False), ("L_l1_ss", False), ("L_l1_gs", True),
    ("L_l2_is", False), ("L_l2_ss", True), ("FrameProj", True),
    ("TokenProj", True), ("Prenet1", True), ("Prenet2", True),
    ("AttentionConvProj", False), ("AttentionEncoderProj", True),
    ("AttentionDecoderProj", False), ("AttentionSelfProj", False))


def _speaker_dims(hp, per_layer: bool = True):
    """(spk_emb_dim of the encoder's layers, of the decoder's): the dim
    where ``spk_emb_architecture`` names the stack, else None."""
    arch = spk_arch(hp) if per_layer else ()
    return tuple(hp.spk_emb_dim if place in arch else None
                 for place in ("encoder", "decoder"))


def _transformer_tts(w: _Writer, hp) -> Dict[str, torch.Tensor]:
    enc_spk, dec_spk = _speaker_dims(hp, per_layer=hp.spk_emb_vers == 1)
    w.stack(hp.encoder_type, "encoder", hp.n_layer_encoder, embedding=True,
            spk_emb_dim=enc_spk)
    if hp.d_model_encoder != hp.d_model_decoder:
        w.linear(("linear",), "linear")
    if hp.gst:
        w.style_embedding()
    if hp.is_multi_speaker and hp.spk_emb_vers == 2:
        w.linear(("spk_proj",), "spk_proj")
    if hp.decoder_type.lower() == "tacotron2":
        w.tacotron2_decoder()   # its frame and stop heads are its own
    else:
        w.ar_decoder(hp.n_layer_decoder, dec_spk, bool(hp.output_type))
        w.linear(("out",), "out")
        w.linear(("stop_token",), "stop_token")
    w.postnet_convs()           # the AR postnet has no "out" Linear
    return w.out


def state_dict_from_flax(params: Mapping, batch_stats: Mapping, hp,
                         vq_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """Flax FastSpeech 2 (transformer or conformer stacks, with or without
    the SQ-VAE bottleneck, with the integrate post model for text-mel-mel
    hparams), SQ-VAE FastSpeech 2 or AR Transformer-TTS (with or without
    GST) trees -> port ``state_dict``."""
    return _write(_Writer(params, batch_stats, vq_stats), hp)


def post_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                              vq_stats: Mapping,
                              hp) -> Dict[str, torch.Tensor]:
    """A flax PostLowEnergy student's trees (``hp.version`` 1 or 5: v1,
    else v2) -> the port's ``build_post_model(hp)`` ``state_dict``."""
    w = _Writer(params, batch_stats, vq_stats)
    w.post_low_energy("", hp, v1=hp.version in (1, 5))
    return w.out


def flax_layouts(hp) -> Dict[str, List[QLeaf]]:
    """Each parameter of the port model ``hp`` names -> the flax leaves
    ``state_dict_from_flax`` fills it from (infer/quantize.py reads them)."""
    w = _Writer(None, None)
    _write(w, hp)
    return w.layouts


def _write(w: _Writer, hp) -> Dict[str, torch.Tensor]:
    if not is_nar_model(hp.model):
        return _transformer_tts(w, hp)
    enc_spk, dec_spk = _speaker_dims(hp)
    w.stack(hp.encoder_type, "encoder", hp.n_layer_encoder, embedding=True,
            spk_emb_dim=enc_spk, accent_emb=hp.accent_emb)
    w.stack(hp.decoder_type, "decoder", hp.n_layer_decoder, embedding=False,
            spk_emb_dim=dec_spk, ctc_out=hp.CTC_training)
    if "middle" in spk_arch(hp):
        w.linear(("spk_proj",), "spk_proj")
    if hp.use_hop:
        w.embed(("hop_emb",), "hop_emb")
    va = ("variance_adaptor",)
    if is_sq_model(hp.model):
        w.sq_codebook(va, "variance_adaptor.")
    elif hp.use_sq_vae:
        w.sq_codebook((), "")
    if hp.use_pos:
        w.vector(va + ("pos", "alpha"), "variance_adaptor.pos.alpha")
    if hp.use_rnn_length:
        w.lstm(va + ("rnn_length", "OptimizedLSTMCell_0"),
               "variance_adaptor.rnn_length")
    w.variance_predictor(va + ("duration_predictor",),
                         "variance_adaptor.duration_predictor")
    for kind, on in (("pitch", hp.pitch_pred), ("energy", hp.energy_pred)):
        if on:
            w.variance_predictor(va + (f"{kind}_predictor",),
                                 f"variance_adaptor.{kind}_predictor")
            w.embed(va + (f"{kind}_embedding",),
                    f"variance_adaptor.{kind}_embedding")
    if hp.postnet_pred:
        w.linear(("postnet", "out"), "postnet.out")
        w.postnet_convs()
    else:
        w.linear(("out",), "out")
    if hp.architecture == "text-mel-mel":
        w.post_low_energy("post_model", hp, v1=False)
        if hp.version in (8, 9):
            w.post_low_energy("post_model_replace_mask", hp, v1=False)
    return w.out


# ---- the LM and the modules that no model builds ---------------------------

def lm_state_dict_from_flax(params: Mapping,
                            num_layers: int) -> Dict[str, torch.Tensor]:
    """flax ``LSTMLanguageModel`` params -> models/lm.py's
    ``LSTMLanguageModel`` ``state_dict``."""
    w = _Writer(params, None)
    for name in ("embed1", "embed2"):
        w.embed((name,), name)
    for i in range(num_layers):
        w.lstm((f"OptimizedLSTMCell_{i}",), f"lstms.{i}")
    for name in ("out1", "out2"):
        w.linear((name,), name)
    return w.out


def encoder_prenet_state_dict_from_flax(params: Mapping,
                                        batch_stats: Mapping
                                        ) -> Dict[str, torch.Tensor]:
    """flax ``EncoderPreNet`` trees -> models/prenets.py's."""
    w = _Writer(params, batch_stats)
    w.embed(("embed",), "embed")
    for i in range(3):
        w.conv1d((f"conv_{i + 1}",), f"convs.{i}")
        w.batch_norm((f"batch_norm_{i + 1}",), f"batch_norms.{i}")
    w.linear(("final_out",), "final_out")
    return w.out


def aligner_state_dict_from_flax(params: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """flax ``Aligner`` params -> models/variance_adaptor.py's."""
    w = _Writer(params, None)
    for i in range(3):
        w.conv1d((f"conv_{i}",), f"convs.{i}")
        w.layer_norm((f"ln_{i}",), f"norms.{i}")
    w.linear(("out",), "out")
    return w.out


def encoder_postprocessing_state_dict_from_flax(
        params: Mapping, n_layers: int, *, embedding: bool = True
) -> Dict[str, torch.Tensor]:
    """flax ``EncoderPostprocessing`` params -> models/encoder.py's; the
    optional tables and the CTC tap where ``params`` holds them."""
    w = _Writer({"": params}, None)         # the stack's paths under ""
    w.encoder_stack("", n_layers, embedding, {})
    for name in ("acc_embed", "gender_embed", "speaker_embed"):
        if name in params:
            w.embed(("", name), f".{name}")
    if "ctc_linear" in params:
        w.linear(("", "ctc_linear"), ".ctc_linear")
    return {k[1:]: v for k, v in w.out.items()}


# ---- the vocoder ------------------------------------------------------------

def _weight_norm_scales(scope: Mapping) -> Dict[str, np.ndarray]:
    """flax ``WeightNorm`` scales of one scope, by the inner conv's name:
    ``WeightNorm_<i>/<conv>/kernel/scale`` (the index is call order)."""
    out = {}
    for key, sub in scope.items():
        if key.startswith("WeightNorm_"):
            for path, scale in sub.items():
                conv, _, rest = path.partition("/")
                if rest == "kernel/scale":
                    out[conv] = np.asarray(scale, np.float32)
    return out


class _VocoderWriter:
    """flax conv kernels -> torch weights (weight-normed or not):
    Conv (k, in, out) -> Conv1d (out, in, k); Conv (kh, 1, in, out) ->
    Conv2d (out, in, kh, 1); ConvTranspose (k, in, out) -> ConvTranspose1d
    (in, out, k) flipped along k (lax.conv_transpose does not flip)."""

    def __init__(self):
        self.out: Dict[str, torch.Tensor] = {}
        self.layouts: Dict[str, List[QLeaf]] = {}

    def _put(self, name: str, array: np.ndarray, leaf: QLeaf = QLeaf(1, 0)):
        self.out[name] = torch.from_numpy(np.ascontiguousarray(array))
        self.layouts[name] = [leaf]

    def conv(self, scope: Mapping, conv: str, name: str, kind: str = "1d"):
        kernel = np.asarray(scope[conv]["kernel"], np.float32)
        if kind == "1d":
            w = kernel.transpose(2, 1, 0)
        elif kind == "2d":
            w = kernel.transpose(3, 2, 0, 1)
        else:                                            # "transposed"
            w = kernel[::-1].transpose(1, 2, 0)
        out_axis = 1 if kind == "transposed" else 0
        self._put(f"{name}.bias", np.asarray(scope[conv]["bias"], np.float32))
        scales = _weight_norm_scales(scope)
        if conv not in scales:
            self._put(f"{name}.weight", w, QLeaf(kernel.ndim, out_axis))
            return
        g = scales[conv]
        shape = [1] * w.ndim
        shape[out_axis] = g.shape[0]
        self._put(f"{name}.parametrizations.weight.original0",
                  g.reshape(shape), QLeaf(1, out_axis))
        self._put(f"{name}.parametrizations.weight.original1", w,
                  QLeaf(kernel.ndim, out_axis))

    def linear(self, scope: Mapping, name: str):
        self._put(f"{name}.weight",
                  np.asarray(scope["kernel"], np.float32).T, QLeaf(2, 0))
        self._put(f"{name}.bias", np.asarray(scope["bias"], np.float32))

    def layer_norm(self, scope: Mapping, name: str):
        self._put(f"{name}.weight", np.asarray(scope["scale"], np.float32))
        self._put(f"{name}.bias", np.asarray(scope["bias"], np.float32))


def vocoder_state_dict_from_flax(params: Mapping, hp, *,
                                 discriminator: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """flax generator params (``hp.vocoder_type`` "hifigan", either
    upsample mode, or "istft") -> the port's generator ``state_dict``; with
    ``discriminator``, flax ``VocoderDiscriminator`` params -> the port's
    discriminator ``state_dict``."""
    return _write_vocoder(_VocoderWriter(), params, hp, discriminator)


def vocoder_flax_layouts(params: Mapping, hp) -> Dict[str, List[QLeaf]]:
    """As ``flax_layouts``, for a generator of
    ``vocoder_state_dict_from_flax``: which convolutions a flax vocoder
    holds is read from ``params``."""
    w = _VocoderWriter()
    _write_vocoder(w, params, hp, False)
    return w.layouts


def _write_vocoder(w: _VocoderWriter, params: Mapping, hp,
                   discriminator: bool) -> Dict[str, torch.Tensor]:
    if discriminator:
        for p in hp.vocoder_periods:
            scope, name = params["mpd"][f"period_{p}"], f"mpd.period_{p}"
            for conv in [c for c in scope if not c.startswith("WeightNorm")]:
                w.conv(scope, conv, f"{name}.{conv}", "2d")
        for i in range(hp.vocoder_num_scales):
            scope, name = params["msd"][f"scale_{i}"], f"msd.scale_{i}"
            for conv in [c for c in scope if not c.startswith("WeightNorm")]:
                w.conv(scope, conv, f"{name}.{conv}")
        return w.out
    if (hp.vocoder_type or "hifigan").lower() == "istft":
        w.conv(params, "embed", "embed")
        w.layer_norm(params["norm_pre"], "norm_pre")
        for i in range(hp.vocoder_convnext_layers):
            scope, name = params[f"block_{i}"], f"block_{i}"
            w.conv(scope, "dwconv", f"{name}.dwconv")
            w.layer_norm(scope["norm"], f"{name}.norm")
            w.linear(scope["pw1"], f"{name}.pw1")
            w.linear(scope["pw2"], f"{name}.pw2")
            w._put(f"{name}.gamma", np.asarray(scope["gamma"], np.float32))
        w.layer_norm(params["norm_post"], "norm_post")
        w.linear(params["head"], "head")
        return w.out
    up_kind = ("transposed" if hp.vocoder_upsample_mode == "transposed"
               else "1d")
    w.conv(params, "conv_pre", "conv_pre")
    for i in range(len(hp.vocoder_upsample_rates)):
        w.conv(params, f"up_{i}", f"up_{i}", up_kind)
        for j in range(len(hp.vocoder_resblock_kernel_sizes)):
            scope, name = params[f"res_{i}_{j}"], f"res_{i}_{j}"
            for conv in [c for c in scope if not c.startswith("WeightNorm")]:
                w.conv(scope, conv, f"{name}.{conv}")
    w.conv(params, "conv_post", "conv_post")
    return w.out
