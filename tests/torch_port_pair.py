"""A small FastSpeech 2, SQ-VAE FastSpeech 2 or AR Transformer-TTS, in both
packages, on the same weights.

Builds the JAX model in fp32, takes its parameter tree's shapes from
``jax.eval_shape`` (no compile), fills it with numpy random values in
which biases, norm scales and BatchNorm running statistics are all
non-trivial, and loads the same values into the PyTorch port through
``state_dict_from_flax``. Used by tests/test_torch_port_*.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.models.transformer_tts import (
    build_transformer_tts as jax_build_transformer_tts)
from transformer_tts_tpu.ops.masks import (
    create_masks as jax_create_masks, pad_mask as jax_pad_mask)
from transformer_tts_tpu.train.trainer import (
    build_fastspeech2 as jax_build_fastspeech2,
    build_sq_fastspeech2 as jax_build_sq_fastspeech2)
from transformer_tts_tpu_torch.compat.from_jax import state_dict_from_flax
from transformer_tts_tpu_torch.config import HParams, is_sq_model
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.models.fastspeech2_sq import (
    build_sq_fastspeech2)
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)

SMALL = dict(vocab_size=40, mel_dim=16, d_model_encoder=32,
             d_model_decoder=32, n_layer_encoder=2, n_layer_decoder=2,
             n_head_encoder=2, n_head_decoder=2,
             ff_conv_kernel_size_encoder=5, ff_conv_kernel_size_decoder=1,
             amp=False, dropout=0.0, dropout_postnet=0.0,
             dropout_variance_adaptor=0.0)

# the conformer FastSpeech 2 of egs/fastspeech2_conformer_ljspeech.py at
# SMALL's size
CONFORMER = dict(encoder_type="conformer", decoder_type="conformer")

# the AR Transformer-TTS of egs/transformer_tts_ljspeech.py at SMALL's
# size, every dropout 0
AR = dict(model="Transformer", reduction_rate=2, dropout_prenet=0.0)

# predictor biases that put random-weight outputs in a useful range:
# ~3 frames per phone, pitch and energy inside their bins
DURATION_BIAS = math.log(1.0 + 3.0)
PITCH_BIAS = 200.0
ENERGY_BIAS = 100.0


def _random_params(shapes, rs):
    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":        # Dense (in, out) or Conv (k, in, out)
            bound = 1.0 / math.sqrt(int(np.prod(x.shape[:-1])))
            return rs.uniform(-bound, bound, x.shape).astype(np.float32)
        if name == "embedding":
            return rs.randn(*x.shape).astype(np.float32)
        base = 0.0 if name in ("bias", "mean") else 1.0
        return (base + 0.1 * rs.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def build_pair(seed=0, **overrides):
    """-> (hp, jax_model, variables, port_model) on the same weights; an
    SQ-VAE FastSpeech 2 when ``overrides`` name it (``model``)."""
    cfg = dict(SMALL, **overrides)
    jhp = JaxHParams(**cfg)
    hp = HParams(**cfg)
    is_sq = is_sq_model(hp.model)
    jmodel = (jax_build_sq_fastspeech2 if is_sq
              else jax_build_fastspeech2)(jhp)
    b, l, t = 2, 8, 32
    text = jnp.ones((b, l), jnp.int32)
    src_mask = jax_pad_mask(jnp.ones((b, l), jnp.int32))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(seed), text, src_mask, t,
        jnp.full((b, l), 4, jnp.int32), jnp.zeros((b, t)),
        jnp.zeros((b, t)), train=False))
    rs = np.random.RandomState(seed)
    params = _random_params(shapes["params"], rs)
    bstats = _random_params(shapes.get("batch_stats", {}), rs)
    va = params["variance_adaptor"]
    for name, bias in (("duration", DURATION_BIAS), ("pitch", PITCH_BIAS),
                       ("energy", ENERGY_BIAS)):
        if f"{name}_predictor" in va:
            va[f"{name}_predictor"]["linear_layer"]["bias"][:] = bias
    variables = {"params": params, "batch_stats": bstats}

    model = (build_sq_fastspeech2 if is_sq else build_fastspeech2)(
        hp, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, bstats, hp))
    model.eval()
    return hp, jmodel, variables, model


def build_ar_pair(seed=0, **overrides):
    """-> (hp, jax_model, variables, port_model) of the AR model on the
    same weights."""
    cfg = dict(SMALL, **AR, **overrides)
    jhp = JaxHParams(**cfg)
    hp = HParams(**cfg)
    jmodel = jax_build_transformer_tts(jhp)
    b, l, t = 2, 8, 6
    pos_text = jnp.tile(jnp.arange(1, l + 1)[None], (b, 1))
    pos_mel = jnp.tile(jnp.arange(1, t + 1)[None], (b, 1))
    src_mask, trg_mask = jax_create_masks(pos_text, pos_mel,
                                          model="transformer")
    # a GST model needs a reference mel at init (any length will do)
    ref_mel = jnp.zeros((b, 24, cfg["mel_dim"])) if cfg.get("gst") else None
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(seed), jnp.ones((b, l), jnp.int32),
        jnp.zeros((b, t, cfg["mel_dim"])), src_mask, trg_mask,
        ref_mel=ref_mel, train=False))
    rs = np.random.RandomState(seed)
    params = _random_params(shapes["params"], rs)
    bstats = _random_params(shapes.get("batch_stats", {}), rs)
    variables = {"params": params, "batch_stats": bstats}

    model = build_transformer_tts(hp, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, bstats, hp))
    model.eval()
    return hp, jmodel, variables, model


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
