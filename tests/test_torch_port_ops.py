"""PyTorch port against the JAX package, op by op, on the CPU in fp32.

Each module of the port's FastSpeech 2 path gets the same numpy inputs and
the same weights as its JAX counterpart. Tolerance 1e-5 abs/rel unless a
test says otherwise: both sides compute in fp32 with sums in different
orders.
"""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.models.encoder import Encoder as JEncoder
from transformer_tts_tpu.models.layers import EncoderLayer as JEncoderLayer
from transformer_tts_tpu.models.postnets import PostConvNet as JPostConvNet
from transformer_tts_tpu.models.variance_adaptor import (
    VarianceAdaptor as JVarianceAdaptor)
from transformer_tts_tpu.ops import length_regulator as jlr
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.ops import positional as jpos
from transformer_tts_tpu.ops.attention import (
    MultiHeadAttention as JMultiHeadAttention)
from transformer_tts_tpu.ops.feedforward import (
    ConvFeedForward as JConvFeedForward)
from transformer_tts_tpu_torch.ops import length_regulator, masks, positional

from torch_port_pair import build_pair, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _text_batch(seed, b=2, l=12, vocab=40):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, vocab, (b, l)).astype(np.int32)
    text[1, l - 4:] = 0
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    return text, pos


def _features(seed, b=2, t=12, d=32):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32)


def test_masks_match_jax():
    text, pos = _text_batch(0)
    pos_mel = np.where(np.arange(20)[None] < np.array([[20], [13]]),
                       np.arange(1, 21)[None], 0).astype(np.int32)
    src, trg = masks.create_masks(torch.as_tensor(pos),
                                  torch.as_tensor(pos_mel))
    jsrc, jtrg = jmasks.create_masks(jnp.asarray(pos), jnp.asarray(pos_mel))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(trg.numpy(), np.asarray(jtrg))
    lengths = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(
        masks.mask_from_lengths(torch.as_tensor(lengths), 9).numpy(),
        np.asarray(jmasks.mask_from_lengths(jnp.asarray(lengths), 9)))


@pytest.mark.parametrize("d_model", [32, 96])
def test_sinusoid_table_matches_jax(d_model):
    # 300 positions: the synthesis text lengths; sin/cos of angles up to
    # 300 rad differ by a few fp32 ulps of the angle between libraries
    ours = positional.sinusoid_table(300, d_model)
    ref = jpos.sinusoid_table(300, d_model)
    _close(ours, ref)


def test_positional_encoder_matches_jax():
    x = _features(1, t=40)
    enc = positional.PositionalEncoder(32, dropout=0.0)
    with torch.no_grad():
        enc.alpha.fill_(1.3)
    ref = jpos.PositionalEncoder(32, dropout=0.0).apply(
        {"params": {"alpha": jnp.array([1.3], jnp.float32)}},
        jnp.asarray(x), train=False)
    _close(enc(torch.as_tensor(x)), ref)


@pytest.mark.parametrize("durations,max_frames", [
    ([[2, 0, 3, 1, 0], [0, 0, 4, 0, 0]], 12),     # zero durations, padding
    ([[5, 4, 6, 2, 3], [7, 7, 7, 7, 7]], 16),     # totals above max_frames
])
def test_length_regulate_matches_jax(durations, max_frames):
    x = _features(2, t=5, d=8)
    dur = np.asarray(durations, np.int32)
    out, mel_len, mel_pos = length_regulator.length_regulate(
        torch.as_tensor(x), torch.as_tensor(dur), max_frames)
    jout, jlen, jpos_ = jlr.length_regulate(jnp.asarray(x), jnp.asarray(dur),
                                            max_frames)
    _close(out, jout, rtol=0, atol=0)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(mel_pos.numpy(), np.asarray(jpos_))


@pytest.mark.parametrize("scale", [1.0, 0.8, 1.2])
def test_durations_from_log_matches_jax(scale):
    rs = np.random.RandomState(3)
    # include exact .5 ties, which both round half to even
    log_d = np.log(np.concatenate([rs.uniform(0.5, 9.0, 40),
                                   [1.5, 2.5, 3.5, 4.5]]) + 1.0)
    log_d = log_d.astype(np.float32)[None]
    ours = length_regulator.durations_from_log(torch.as_tensor(log_d), 1.0,
                                               scale)
    ref = jlr.durations_from_log(jnp.asarray(log_d), 1.0, scale)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_conv_feed_forward_matches_jax(pair):
    _, _, variables, model = pair
    x = _features(4)
    ref = JConvFeedForward(32, 5, dropout=0.0).apply(
        {"params": variables["params"]["encoder"]["layers_0"]["ff"]},
        jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = model.encoder.layers[0].ff(torch.as_tensor(x))
    _close(ours, ref)


def test_multi_head_attention_matches_jax(pair):
    _, _, variables, model = pair
    x = _features(5)
    mask = np.ones((2, 1, 12), bool)
    mask[1, 0, 7:] = False
    ref, ref_probs = JMultiHeadAttention(heads=2, d_model=32,
                                         dropout=0.0).apply(
        {"params": variables["params"]["encoder"]["layers_0"]["attn"]},
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask),
        train=False, collect_attn=True)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        ours, probs = model.encoder.layers[0].attn(
            xt, xt, xt, torch.as_tensor(mask), collect_attn=True)
    _close(ours, ref)
    _close(probs, ref_probs)


def test_encoder_layer_matches_jax(pair):
    _, _, variables, model = pair
    x = _features(6)
    mask = np.ones((2, 1, 12), bool)
    mask[0, 0, 9:] = False
    ref, _ = JEncoderLayer(32, 2, 5, dropout=0.0).apply(
        {"params": variables["params"]["encoder"]["layers_0"]},
        jnp.asarray(x), jnp.asarray(mask), train=False)
    with torch.no_grad():
        ours, _ = model.encoder.layers[0](torch.as_tensor(x),
                                          torch.as_tensor(mask))
    _close(ours, ref)


def test_encoder_matches_jax(pair):
    _, _, variables, model = pair
    text, pos = _text_batch(7)
    mask = jmasks.pad_mask(jnp.asarray(pos))
    ref, _ = JEncoder(40, 32, 2, 2, 5, dropout=0.0).apply(
        {"params": variables["params"]["encoder"]}, jnp.asarray(text), mask,
        train=False)
    with torch.no_grad():
        ours, _ = model.encoder(torch.as_tensor(text).long(),
                                masks.pad_mask(torch.as_tensor(pos)))
    _close(ours, ref)


def _variance_adaptor_pair(pair, teacher_forced):
    _, _, variables, model = pair
    x = _features(8, t=10)
    src = np.ones((2, 1, 10), bool)
    src[1, 0, 6:] = False
    rs = np.random.RandomState(9)
    t = 40
    targets = {}
    if teacher_forced:
        d = rs.randint(0, 5, (2, 10)).astype(np.int32)
        d[1, 6:] = 0
        targets = dict(duration_target=d,
                       pitch_target=rs.uniform(60, 800, (2, t)),
                       energy_target=rs.uniform(0, 320, (2, t)))
        targets = {k: v.astype(v.dtype if k == "duration_target"
                               else np.float32) for k, v in targets.items()}
    ref = JVarianceAdaptor(32, dropout=0.0).apply(
        {"params": variables["params"]["variance_adaptor"]},
        jnp.asarray(x), jnp.asarray(src), t,
        **{k: jnp.asarray(v) for k, v in targets.items()}, train=False)
    with torch.no_grad():
        ours = model.variance_adaptor(
            torch.as_tensor(x), torch.as_tensor(src), t,
            **{k: torch.as_tensor(v) for k, v in targets.items()})
    return ours, ref


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_variance_adaptor_matches_jax(pair, teacher_forced):
    ours, ref = _variance_adaptor_pair(pair, teacher_forced)
    assert int(ref.mel_len.min()) > 0
    for field in ("x", "log_duration", "text_dur_predicted"):
        _close(getattr(ours, field), getattr(ref, field))
    # raw-Hz pitch and raw energy are O(100): same relative tolerance
    for field in ("pitch", "energy"):
        _close(getattr(ours, field), getattr(ref, field), rtol=1e-5,
               atol=1e-3)
    for field in ("mel_len", "mel_pos", "mel_mask"):
        np.testing.assert_array_equal(to_np(getattr(ours, field)),
                                      to_np(getattr(ref, field)))


def test_variance_bins_match_jax(pair):
    model = pair[3]
    va = model.variance_adaptor
    ref_pitch = jnp.exp(jnp.linspace(jnp.log(71.0), jnp.log(795.8), 255))
    ref_energy = jnp.linspace(0.0, 315.0, 255)
    _close(va.pitch_bins, ref_pitch, rtol=1e-6, atol=0)
    _close(va.energy_bins, ref_energy, rtol=1e-6, atol=1e-6)


def test_postconvnet_matches_jax(pair):
    _, _, variables, model = pair
    x = _features(10, t=20)
    ref_pre, ref_post = JPostConvNet(32, 16, dropout=0.0).apply(
        {"params": variables["params"]["postnet"],
         "batch_stats": variables["batch_stats"]["postnet"]},
        jnp.asarray(x), train=False)
    with torch.no_grad():
        pre, post = model.postnet(torch.as_tensor(x))
    _close(pre, ref_pre)
    _close(post, ref_post)


# ---- the port stands alone -------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "transformer_tts_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "transformer_tts_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "train_step_ab.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    for module in ("models/transformer_tts.py", "models/decoder.py",
                   "models/prenets.py", "models/layers.py",
                   "infer/synthesize.py", "train/trainer.py", "utils.py",
                   "train/tb_writer.py", "cli/parse_hparams.py",
                   "cli/train.py", "cli/synthesize.py",
                   "ops/melspectrogram.py", "ops/features.py",
                   "vocoder/generator.py", "vocoder/discriminator.py",
                   "vocoder/trainer.py", "cli/prepare_data.py",
                   "cli/train_vocoder.py", "compat/torch_import.py",
                   "egs/synthetic_overfit.py", "egs/full_pipeline.py"):
        assert f"transformer_tts_tpu_torch/{module}" in names, module
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imported_roots(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_without_nvcc_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transformer_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in %r + ('triton',))\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={"PATH": "/usr/bin:/bin"}, timeout=120)
