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


def conditioning_inputs(hp, b, l):
    """Dummy speaker, accent and hop-size inputs of a conditioned model's
    init (the JAX trainer's ``init_fastspeech2_state`` gives the same)."""
    kw = {}
    if hp.is_multi_speaker:
        kw["spk_emb"] = (jnp.zeros((b,), jnp.int32)
                         if hp.spk_emb_type == "speaker_id"
                         else jnp.zeros((b, hp.spk_emb_dim)))
    if hp.accent_emb:
        kw["accent"] = jnp.zeros((b, l), jnp.int32)
    if hp.use_hop:
        kw["hop_size"] = jnp.zeros((b,), jnp.int32)
    return kw


def build_pair(seed=0, **overrides):
    """-> (hp, jax_model, variables, port_model) on the same weights; an
    SQ-VAE FastSpeech 2 when ``overrides`` name it (``model``); speakers,
    accents, hop sizes, CTC, ``use_pos`` and ``use_rnn_length`` as the
    hparams ask."""
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
        jnp.zeros((b, t)), train=False, **conditioning_inputs(jhp, b, l)))
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
    same weights, with speakers as the hparams ask."""
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
    spk = conditioning_inputs(jhp, b, l).get("spk_emb")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(seed), jnp.ones((b, l), jnp.int32),
        jnp.zeros((b, t, cfg["mel_dim"])), src_mask, trg_mask, spk,
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


NOAM_EPS = 1e-9             # Adam's eps under the Noam schedule, both packages
UPDATE_ATOL = 1e-6          # the train-step tests' bound on an update


def settled_update(got, want, lr):
    """The elements of one parameter whose first Adam update the train-step
    tests hold the two packages to UPDATE_ATOL on. The update is
    lr * g / (|g| + eps), whose slope lr * eps / (|g| + eps)^2 is steep
    where |g| is small, so an element counts only where the JAX gradient
    ``want`` is well above its disagreement with the port's ``got`` (past
    1e-7 and 10x that disagreement) and the disagreement moves the update
    by at most half of it. Elsewhere the update is any value in
    [-lr, lr] in either package, which the tests bound apart."""
    diff = np.abs(got - want)
    least = np.maximum(np.abs(want) - diff, 0.0)
    return ((np.abs(want) > np.maximum(1e-7, 10 * diff))
            & (lr * NOAM_EPS * diff / (least + NOAM_EPS) ** 2
               <= UPDATE_ATOL / 2))


def write_engine_checkpoints(root, cfg, variables, model, *, stats_seed=None):
    """The same weights as a JAX checkpoint (the JAX package's
    ``save_checkpoint``, epoch 1, under ``root/jax``) and a port one
    (``train.checkpoint.save_checkpoint``, ``root/port``), each beside an
    ``hparams.py`` of ``cfg``; with ``stats_seed`` also corpus mean and
    variance files that both name. -> (jax_dir, port_dir)."""
    import os
    import types

    from transformer_tts_tpu.train import checkpoint as jax_ckpt
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint

    cfg = dict(cfg)
    root = str(root)
    if stats_seed is not None:
        rs = np.random.RandomState(stats_seed)
        for key, value in (("mean_file", rs.randn(cfg["mel_dim"])),
                           ("var_file", rs.uniform(0.5, 2.0,
                                                   cfg["mel_dim"]))):
            cfg[key] = os.path.join(root, f"{key}.npy")
            np.save(cfg[key], value.astype(np.float32))
    jax_dir, port_dir = os.path.join(root, "jax"), os.path.join(root, "port")
    state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        vq_stats={}, step=np.asarray(0, np.int32))
    jax_ckpt.save_checkpoint(jax_dir, state, 1, with_optimizer=False)
    save_checkpoint(model, port_dir)
    for d in (jax_dir, port_dir):
        with open(os.path.join(d, "hparams.py"), "w") as fh:
            fh.write("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return jax_dir, port_dir


# the engine tests' buckets: text 8 and 16 at 4 frames per phone, so mel
# budgets of 32 and 64 frames
ENGINE_BUCKETS = dict(text_buckets=(8, 16), length_buckets=(32, 64, 128))
ENGINE = dict(batch_size=2, frames_per_phone=4, text_buckets=(8, 16))
# a stop-token bias at which the random AR models stop at different
# steps, some within the budget and some not
AR_STOP_BIAS = -0.7
# a HiFi-GAN small enough for the CPU (hop 8, receptive field 7 frames)
TINY_VOCODER = dict(vocoder_upsample_rates=(4, 2),
                    vocoder_upsample_kernel_sizes=(8, 4),
                    vocoder_channels=16, vocoder_resblock_kernel_sizes=(3,),
                    vocoder_resblock_dilations=((1, 3),))
ENGINE_FAMILIES = ("transformer", "conformer", "ar", "gst")
# five requests in three batches of at most two, sorted by length:
# (5, 7), (8, 12) and (16) phones, padded to buckets 8, 16 and 16
ENGINE_TEXTS = [[1, 2, 3, 4, 5], list(range(3, 10)), list(range(2, 14)),
                [7] * 8, list(range(20, 36))]


def _mel_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    peak = max(1.0, np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * peak)


def assert_results_match(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _mel_close(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["durations"], b["durations"])


def set_stop_bias(variables, model, bias):
    """The AR pair's stop-token bias, in both packages."""
    variables["params"]["stop_token"]["bias"][:] = bias
    with torch.no_grad():
        model.stop_token.bias.fill_(bias)


def engine_pair(family, root, seed=0):
    """A small model of ``family`` ("transformer" or "conformer"
    FastSpeech 2, "ar", "gst") in both packages' checkpoints
    (``write_engine_checkpoints``, with corpus statistics; the hparams
    carry ``TINY_VOCODER``). -> (jax_dir, port_dir, engine keywords: a
    GST model's ``ref_mel`` file)."""
    import os

    over = dict(ENGINE_BUCKETS, **TINY_VOCODER)
    if family in ("transformer", "conformer"):
        extra = CONFORMER if family == "conformer" else {}
        _, _, variables, model = build_pair(seed, **extra, **over)
        cfg = dict(SMALL, **extra, **over)
    else:
        extra = dict(gst=True) if family == "gst" else {}
        _, _, variables, model = build_ar_pair(seed, **extra, **over)
        cfg = dict(SMALL, **AR, **extra, **over)
        set_stop_bias(variables, model, AR_STOP_BIAS)
    jax_dir, port_dir = write_engine_checkpoints(root, cfg, variables, model,
                                                 stats_seed=seed + 3)
    kw = {}
    if family == "gst":
        kw["ref_mel"] = os.path.join(str(root), "ref_mel.npy")
        np.save(kw["ref_mel"], np.random.RandomState(seed + 4).randn(
            24, cfg["mel_dim"]).astype(np.float32))
    return jax_dir, port_dir, kw


def write_tiny_vocoder(root, mel_dim=SMALL["mel_dim"]):
    """A ``TINY_VOCODER`` generator export (random weights) in ``root``."""
    import os

    from transformer_tts_tpu_torch.vocoder.trainer import (
        GENERATOR_NAME, build_vocoder)

    gen = build_vocoder(HParams(mel_dim=mel_dim, **TINY_VOCODER), amp=False,
                        device="cpu", seed=5)
    os.makedirs(root, exist_ok=True)
    torch.save(gen.state_dict(), os.path.join(root, GENERATOR_NAME))
    return str(root)


# ---- serving export (tests/test_torch_port_export*.py) ----------------------

EXPORT_ENGINE = dict(ENGINE, text_buckets=(8,))
XVECTOR_ENGINE = dict(is_multi_speaker=True, spk_emb_type="x_vector",
                      spk_emb_dim=512,
                      spk_emb_architecture="encoder,middle,decoder",
                      use_hop=True)


def export_engine(family, root, port_dir=None, **kw):
    """A port ``TTSEngine`` at ``EXPORT_ENGINE`` (one bucket, 8) on the CPU
    of ``family``: an ``engine_pair`` family, "xvector" (x-vectors and hop
    sizes) or "int8" (the transformer with int8 weights); ``port_dir`` a
    checkpoint of it written already."""
    import os

    from transformer_tts_tpu_torch.infer.engine import TTSEngine

    extra = {}
    if port_dir is None and family == "xvector":
        os.makedirs(root, exist_ok=True)
        _, _, variables, model = build_pair(**XVECTOR_ENGINE,
                                            **ENGINE_BUCKETS)
        _, port_dir = write_engine_checkpoints(
            root, dict(SMALL, **XVECTOR_ENGINE, **ENGINE_BUCKETS), variables,
            model, stats_seed=3)
    elif port_dir is None:
        _, port_dir, extra = engine_pair(
            "transformer" if family == "int8" else family, root)
    if family == "int8":
        kw["quantize"] = "int8"
    return TTSEngine(port_dir, device="cpu", **dict(EXPORT_ENGINE, **kw),
                     **extra)


def export_inputs(engine, bucket, texts=None):
    """``engine``'s padded inputs of ``texts`` (the first two
    ``ENGINE_TEXTS`` by default) at ``bucket``, with a speaker array for
    an x-vector model."""
    texts = ENGINE_TEXTS[:2] if texts is None else texts
    inputs = engine._padded(texts, engine.batch_size, bucket)
    if not engine.is_xvector:
        return inputs
    voice = np.linspace(-1, 1, engine.spk_emb_dim, dtype=np.float32)
    return (*inputs, engine._speakers(range(len(texts)),
                                      [voice] * len(texts),
                                      engine.batch_size))


def load_artifact(out_dir, entry):
    import os
    return torch.export.load(os.path.join(out_dir, entry["file"])).module()
