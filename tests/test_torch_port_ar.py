"""The port's AR Transformer-TTS slice against the JAX package, on the CPU
in fp32.

A small model (d 32, 2+2 layers, r 2, every dropout 0) on the same
weights in both packages (tests/torch_port_pair.build_ar_pair). Module by
module at 1e-5 (fp32 sums in other orders); the whole teacher-forced
forward, the KV-cached decode and ``synthesize_transformer_tts`` at 1e-4
(several layers of such sums, then a feedback loop of 12 steps); one full
``make_transformer_train_step`` with the FastSpeech 2 step's rules (loss
at 1e-5 relative, gradients at 1e-4 of their own scale, Adam's first
update exact where the gradient is above rounding noise); the losses, the
masks, the converter both ways, the data layer and both CLIs.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat.torch_import import (
    convert_transformer_state_dict)
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.data import batching as jax_batching
from transformer_tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from transformer_tts_tpu.infer.synthesize import (
    synthesize_transformer_tts as jax_synthesize)
from transformer_tts_tpu.models.postnets import PostConvNet as JPostConvNet
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.ops import positional as jpos
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    _guided_attention_loss as jax_guided_attention_loss,
    make_transformer_train_step as jax_train_step)
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import state_dict_from_flax
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.data import batching
from transformer_tts_tpu_torch.data.dataset import TTSDataset
from transformer_tts_tpu_torch.infer import synthesize as synth_module
from transformer_tts_tpu_torch.infer.synthesize import (
    _ar_check, _ar_init, synthesize_transformer_tts)
from transformer_tts_tpu_torch.models.postnets import PostConvNet
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops import masks, positional
from transformer_tts_tpu_torch.train import losses, schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, _guided_attention_loss, init_transformer_state,
    make_transformer_train_step)

from torch_port_pair import AR, SMALL, build_ar_pair, settled_update, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(SMALL, **AR)


@pytest.fixture(scope="module")
def pair():
    return build_ar_pair()


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _positions(lengths, t):
    lengths = np.asarray(lengths)[:, None]
    return np.where(np.arange(t)[None] < lengths, np.arange(1, t + 1)[None],
                    0).astype(np.int32)


def _text(seed, b=2, l=10, lengths=(10, 7)):
    rs = np.random.RandomState(seed)
    pos = _positions(lengths[:b], l)
    text = np.where(pos > 0, rs.randint(1, 40, (b, l)), 0).astype(np.int32)
    return text, pos


def _features(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ar_masks(pos_text, pos_mel):
    jm = jmasks.create_masks(jnp.asarray(pos_text), jnp.asarray(pos_mel),
                             model="transformer")
    tm = masks.create_masks(torch.as_tensor(pos_text),
                            torch.as_tensor(pos_mel), model="transformer")
    return jm, tm


def _counting(monkeypatch):
    """Record the causal flag of every call to the attention's kernel
    wrapper (its plain version on the CPU)."""
    calls = []
    real = port_attention.flash_attention

    def counting(*args, **kw):
        calls.append(kw.get("causal", False))
        return real(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counting)
    return calls


# ---- masks and positions ---------------------------------------------------

@pytest.mark.parametrize("fix_mask", [None, 3])
def test_ar_masks_match_jax(fix_mask):
    pos_text = _positions([10, 6], 10)
    pos_mel = _positions([9, 4], 9)
    jsrc, jtrg = jmasks.create_masks(jnp.asarray(pos_text),
                                     jnp.asarray(pos_mel),
                                     model="transformer", fix_mask=fix_mask)
    src, trg = masks.create_masks(torch.as_tensor(pos_text),
                                  torch.as_tensor(pos_mel),
                                  model="transformer", fix_mask=fix_mask)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(trg.numpy(), np.asarray(jtrg))
    assert trg.shape == (2, 9, 9)
    # FastSpeech 2 keeps its pad mask; the band goes into src_mask alone
    src_fs, trg_fs = masks.create_masks(torch.as_tensor(pos_text),
                                        torch.as_tensor(pos_mel),
                                        fix_mask=fix_mask)
    assert torch.equal(src_fs, src) and trg_fs.shape == (2, 1, 9)


@pytest.mark.parametrize("size,context", [(7, 3), (12, 5), (5, 1)])
def test_no_peek_and_band_masks_match_jax(size, context):
    np.testing.assert_array_equal(masks.no_peek_mask(size).numpy(),
                                  np.asarray(jmasks.no_peek_mask(size)))
    np.testing.assert_array_equal(
        masks.band_mask(size, context).numpy(),
        np.asarray(jmasks.band_mask(size, context)))


@pytest.mark.parametrize("offset", [0, 7, "tensor"])
def test_positional_encoder_offset_matches_jax(offset):
    x = _features(1, 2, 1 if offset == "tensor" else 5, 32)
    step = 11 if offset == "tensor" else offset
    enc = positional.PositionalEncoder(32, dropout=0.0)
    with torch.no_grad():
        enc.alpha.fill_(1.3)
    ref = jpos.PositionalEncoder(32, dropout=0.0).apply(
        {"params": {"alpha": jnp.array([1.3], jnp.float32)}},
        jnp.asarray(x), train=False, offset=step)
    arg = torch.tensor(step) if offset == "tensor" else step
    _close(enc(torch.as_tensor(x), offset=arg), ref)


# ---- modules ----------------------------------------------------------------

def test_decoder_prenet_matches_jax(pair):
    _, jmodel, variables, model = pair
    x = _features(2, 2, 9, 16)
    ref = jmodel.apply(variables, jnp.asarray(x), method=lambda m, x:
                       m.decoder.decoder_prenet(x, train=False))
    with torch.no_grad():
        ours = model.decoder.decoder_prenet(torch.as_tensor(x))
    _close(ours, ref)
    names = [n for n, _ in model.named_parameters()
             if "decoder_prenet" in n]
    assert names == ["decoder.decoder_prenet.layer.fc1.weight",
                     "decoder.decoder_prenet.layer.fc1.bias",
                     "decoder.decoder_prenet.layer.fc2.weight",
                     "decoder.decoder_prenet.layer.fc2.bias"]


def test_decoder_prenet_drops_in_train_mode_only(pair):
    model = build_transformer_tts(HParams(**dict(CFG, dropout_prenet=0.5)),
                                  device="cpu")
    prenet = model.decoder.decoder_prenet
    x = torch.as_tensor(_features(3, 2, 9, 16))
    with torch.no_grad():
        assert torch.equal(prenet.eval()(x), prenet(x))
        torch.manual_seed(0)
        assert not torch.equal(prenet.train()(x), prenet.eval()(x))


def _layer_inputs(t=12):
    x = _features(4, 2, t, 32)
    e = _features(5, 2, 10, 32)
    src = masks.pad_mask(torch.as_tensor(_positions([10, 7], 10)))
    trg = masks.create_masks(torch.as_tensor(_positions([10, 7], 10)),
                             torch.as_tensor(_positions([t, t - 5], t)),
                             model="transformer")[1]
    return x, e, src.numpy(), trg.numpy()


@pytest.mark.parametrize("collect_attn", [False, True])
def test_decoder_layer_matches_jax(pair, collect_attn):
    _, jmodel, variables, model = pair
    x, e, src, trg = _layer_inputs()
    ref = jmodel.apply(
        variables, *(jnp.asarray(a) for a in (x, e, src, trg)),
        method=lambda m, *a: m.decoder.layers[0](
            *a, train=False, collect_attn=collect_attn))
    with torch.no_grad():
        ours = model.decoder.layers[0](
            *(torch.as_tensor(a) for a in (x, e, src, trg)),
            collect_attn=collect_attn)
    _close(ours[0], ref[0])
    if collect_attn:
        _close(ours[1], ref[1])
        _close(ours[2], ref[2])
    else:
        assert ours[1] is None and ours[2] is None


def _empty_caches(model, b, steps, n_layers=1):
    heads = model.n_head_decoder
    d_k = model.d_model_decoder // heads
    return tuple((np.zeros((b, heads, steps, d_k), np.float32),
                  np.zeros((b, heads, steps, d_k), np.float32))
                 for _ in range(n_layers))


def test_cached_decoder_layer_matches_jax(pair):
    _, jmodel, variables, model = pair
    steps = 6
    x, e, src, _ = _layer_inputs()
    (cache,) = _empty_caches(model, 2, steps)
    jcache = tuple(jnp.asarray(c) for c in cache)
    tcache = tuple(torch.as_tensor(c.copy()) for c in cache)
    cross = model.decoder.layers[0].cross_kv(torch.as_tensor(e))
    for i in range(3):
        trg = np.broadcast_to(np.arange(steps)[None, None] <= i,
                              (2, 1, steps))
        ref = jmodel.apply(
            variables, jnp.asarray(x[:, i:i + 1]), jnp.asarray(e),
            jnp.asarray(src), jnp.asarray(trg),
            method=lambda m, *a: m.decoder.layers[0](
                *a, train=False, self_cache=jcache, cache_index=i))
        with torch.no_grad():
            ours = model.decoder.layers[0](
                torch.as_tensor(x[:, i:i + 1]), torch.as_tensor(e),
                torch.as_tensor(src), torch.as_tensor(trg.copy()),
                self_cache=tcache, cross_cache=cross,
                cache_index=torch.tensor([i]))
        _close(ours[0], ref[0])
        assert len(ours) == 3
        jcache = ref[3]
        for a, b in zip(tcache, jcache):           # written in place
            _close(a, b)


@pytest.mark.parametrize("cached", [False, True])
def test_decoder_matches_jax(pair, cached):
    _, jmodel, variables, model = pair
    t = 7
    trg_in = _features(6, 2, t, 16)
    e = _features(7, 2, 10, 32)
    src = masks.pad_mask(torch.as_tensor(_positions([10, 7], 10))).numpy()
    if not cached:
        trg = masks.create_masks(torch.as_tensor(_positions([10, 7], 10)),
                                 torch.as_tensor(_positions([t, 4], t)),
                                 model="transformer")[1].numpy()
        ref = jmodel.apply(
            variables, *(jnp.asarray(a) for a in (trg_in, e, src, trg)),
            method=lambda m, *a: m.decoder(*a, train=False,
                                           collect_attn=True))
        with torch.no_grad():
            ours = model.decoder(*(torch.as_tensor(a)
                                   for a in (trg_in, e, src, trg)),
                                 collect_attn=True)
        for a, b in zip(ours, ref):
            _close(a, b)
        return
    caches = _empty_caches(model, 2, t, 2)
    jcaches = tuple(tuple(jnp.asarray(c) for c in lc) for lc in caches)
    tcaches = tuple(tuple(torch.as_tensor(c.copy()) for c in lc)
                    for lc in caches)
    with torch.no_grad():
        cross = model.decoder.precompute_cross_kv(torch.as_tensor(e))
    for i in range(t):
        trg = np.broadcast_to(np.arange(t)[None, None] <= i, (2, 1, t))
        ref = jmodel.apply(
            variables, jnp.asarray(trg_in[:, i:i + 1]), jnp.asarray(e),
            jnp.asarray(src), jnp.asarray(trg),
            method=lambda m, *a: m.decoder(*a, train=False, caches=jcaches,
                                           cache_index=i, pos_offset=i))
        with torch.no_grad():
            ours = model.decoder(
                torch.as_tensor(trg_in[:, i:i + 1]), torch.as_tensor(e),
                torch.as_tensor(src), torch.as_tensor(trg.copy()),
                caches=tcaches, cache_index=torch.tensor([i]),
                pos_offset=torch.tensor(i), cross_kvs=cross)
        _close(ours[0], ref[0])
        jcaches = ref[3]
    for lc, jlc in zip(tcaches, jcaches):
        for a, b in zip(lc, jlc):
            _close(a, b)


@pytest.mark.parametrize("identity_compat", [False, True])
def test_postnet_ar_mode_matches_jax(pair, identity_compat):
    _, _, variables, model = pair
    x = _features(8, 2, 11, 32)           # (B, t, mel*r)
    ref = JPostConvNet(32, 16, reduction_rate=2, dropout=0.0,
                       prev_version=False,
                       identity_compat=identity_compat).apply(
        {"params": variables["params"]["postnet"],
         "batch_stats": variables["batch_stats"]["postnet"]},
        jnp.asarray(x), train=False)
    postnet = PostConvNet(32, 16, 2, 0.0, prev_version=False,
                          identity_compat=identity_compat)
    postnet.load_state_dict(model.postnet.state_dict())
    with torch.no_grad():
        ours = postnet.eval()(torch.as_tensor(x))
    _close(ours, ref)
    if identity_compat:
        assert torch.equal(ours, torch.as_tensor(x))
    assert not hasattr(postnet, "out")


def test_fastspeech2_postnet_mode_is_unchanged():
    postnet = PostConvNet(32, 16, 1, 0.0)
    x = torch.as_tensor(_features(9, 2, 11, 32))
    with torch.no_grad():
        pre, post = postnet.eval()(x)
    assert torch.equal(pre, postnet.out(x)) and pre.shape == (2, 11, 16)


def _forward_inputs(t=9):
    text, pos_text = _text(10)
    trg = _features(11, 2, t, 16)
    pos_mel = _positions([t, 5], t)
    return text, pos_text, trg, pos_mel


@pytest.mark.parametrize("collect_attn", [False, True])
def test_teacher_forced_forward_matches_jax(pair, collect_attn):
    _, jmodel, variables, model = pair
    text, pos_text, trg, pos_mel = _forward_inputs()
    (jsrc, jtrg), (src, tmask) = _ar_masks(pos_text, pos_mel)
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(trg), jsrc,
                       jtrg, train=False, collect_attn=collect_attn)
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(), torch.as_tensor(trg),
                     src, tmask, collect_attn=collect_attn)
    assert ours.mel_pre.shape == (2, 9, 32) and ours.stop_token.shape == (
        2, 9, 2)
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
    for name in ("attn_enc", "attn_dec_dec", "attn_dec_enc"):
        if collect_attn:
            _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
        else:
            assert getattr(ours, name) is None


def test_conformer_encoder_forward_matches_jax():
    # encoder_type="conformer" is accepted as in the JAX package
    _, jmodel, variables, model = build_ar_pair(encoder_type="conformer")
    text, pos_text, trg, pos_mel = _forward_inputs()
    (jsrc, jtrg), (src, tmask) = _ar_masks(pos_text, pos_mel)
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(trg), jsrc,
                       jtrg, train=False)
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(), torch.as_tensor(trg),
                     src, tmask)
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)


def test_kv_cached_decode_matches_full_forward(pair, monkeypatch):
    # the port's copy of tests/test_transformer_tts.py's cache test: the
    # same inputs both ways, every cached step equals the full forward's row
    model = pair[3]
    calls = _counting(monkeypatch)
    b, l, steps = 2, 10, 6
    rs = np.random.RandomState(5)
    text = torch.as_tensor(rs.randint(1, 30, (b, l))).long()
    pos_text = torch.arange(1, l + 1)[None].repeat(b, 1)
    trg = torch.as_tensor(rs.randn(b, steps, 16).astype(np.float32))
    src_mask, trg_mask = masks.create_masks(
        pos_text, torch.arange(1, steps + 1)[None].repeat(b, 1),
        model="transformer")
    with torch.no_grad():
        out = model(text, trg, src_mask, trg_mask)
        e_outputs, _ = model.encode(text, src_mask)
        caches = _ar_init(model, b, steps, "cpu")["caches"]
        for i in range(steps):
            group, stop = model.decode_step(
                trg[:, i:i + 1], e_outputs, src_mask, caches,
                torch.tensor(i))
            _close(group[:, 0], out.mel_pre[:, i], rtol=2e-4, atol=2e-5)
            _close(stop[:, 0], out.stop_token[:, i], rtol=2e-4, atol=2e-5)
    assert calls == []


def test_incremental_decode_needs_a_one_wide_decoder_ffn():
    model = build_transformer_tts(
        HParams(**dict(CFG, ff_conv_kernel_size_decoder=3)), device="cpu")
    with pytest.raises(ValueError, match="ff_conv_kernel_size_decoder"):
        _ar_check(model)


# ---- synthesis --------------------------------------------------------------

def _stop_probs(model, text, pos_text, steps):
    """(B, steps) mean stop probability of each decode step, the loop run
    to its end (a row's stop does not change what the loop feeds back)."""
    src_mask = masks.pad_mask(pos_text)
    with torch.no_grad():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        carry = _ar_init(model, text.shape[0], steps, "cpu")
        prev, probs = carry["prev"], []
        for i in range(steps):
            group, stop = model.decode_step(prev, e_outputs, src_mask,
                                            carry["caches"], i, cross)
            probs.append(torch.sigmoid(stop[:, 0]).mean(-1))
            prev = group[:, :, :model.mel_dim]
    return torch.stack(probs, 1).numpy()


def _forced_threshold(probs):
    """A stop threshold that row 0 crosses in the first half of the
    loop, as far from every step's probability as the values allow."""
    vals = np.sort(probs.ravel())
    mids = (vals[1:] + vals[:-1]) / 2
    gaps = vals[1:] - vals[:-1]
    ok = mids < probs[0, :probs.shape[1] // 2].max()
    best = np.argmax(np.where(ok, gaps, -1.0))
    assert gaps[best] > 1e-3
    return float(mids[best])


def test_synthesize_matches_jax(pair, monkeypatch):
    _, jmodel, variables, model = pair
    steps, r = 12, 2
    text, pos_text = _text(12)
    tt, tp = torch.as_tensor(text).long(), torch.as_tensor(pos_text)
    threshold = _forced_threshold(_stop_probs(model, tt, tp, steps))
    rs = np.random.RandomState(13)
    mean = rs.randn(16).astype(np.float32)
    var = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    jmel, jlen = jax_synthesize(
        jmodel, variables, jnp.asarray(text), jnp.asarray(pos_text), None,
        None, jnp.asarray(mean), jnp.asarray(var), max_steps=steps,
        stop_threshold=threshold)
    jlen = np.asarray(jlen)
    assert jlen[0] <= steps // 2 * r            # the forced stop
    calls = _counting(monkeypatch)
    outs = []
    for every in (1, 8):      # the host's stop check: the extra steps
        monkeypatch.setattr(synth_module, "DONE_CHECK_EVERY", every)
        outs.append(synthesize_transformer_tts(
            model, tt, tp, torch.as_tensor(mean), torch.as_tensor(var),
            max_steps=steps, stop_threshold=threshold))
    assert calls == []                          # the decode runs no kernel
    for mel, lengths in outs:
        assert mel.shape == (2, steps * r, 16) and mel.dtype == torch.float32
        np.testing.assert_array_equal(lengths.numpy(), jlen)
        _close(mel, jmel, **MODEL_TOL)
        for row, n in enumerate(jlen):
            assert not mel[row, n:].any()
    assert torch.equal(outs[0][0], outs[1][0])


# ---- losses -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_transformer_tts_loss_matches_jax(masked):
    rs = np.random.RandomState(14)
    b, t, mel_dim = 2, 18, 16
    arrays = [rs.randn(b, t, mel_dim).astype(np.float32) for _ in range(3)]
    logits = (3 * rs.randn(b, t)).astype(np.float32)
    stop = (rs.rand(b, t) > 0.7).astype(np.float32)
    mask = _positions([t, 11], t) > 0 if masked else None
    pre, post, target = arrays

    def call(fn, to):
        return fn(to(pre), to(post), to(logits), to(target), to(stop),
                  mask=None if mask is None else to(mask),
                  positive_weight=5.0)[1]

    ref = call(jax_losses.transformer_tts_loss, jnp.asarray)
    ours = call(losses.transformer_tts_loss, torch.as_tensor)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == torch.float32
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("pos_weight", [1.0, 5.0])
def test_stop_token_loss_is_stable_and_matches_jax(pos_weight):
    logits = np.array([[-200.0, -3.0, 0.0, 4.0, 150.0]], np.float32)
    target = np.array([[1.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    ref = jax_losses.stop_token_loss(jnp.asarray(logits),
                                     jnp.asarray(target), pos_weight)
    ours = losses.stop_token_loss(torch.as_tensor(logits),
                                  torch.as_tensor(target), pos_weight)
    assert torch.isfinite(ours)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    # against torch's own BCE with pos_weight on moderate logits
    mid = torch.as_tensor(logits[:, 1:4])
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        mid, torch.as_tensor(target[:, 1:4]),
        pos_weight=torch.tensor(pos_weight))
    np.testing.assert_allclose(
        float(losses.stop_token_loss(mid, torch.as_tensor(target[:, 1:4]),
                                     pos_weight)), float(bce), rtol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_guided_attention_loss_matches_jax(stacked):
    rs = np.random.RandomState(15)
    shape = (2, 2, 2, 9, 7) if stacked else (2, 9, 7)
    attn = rs.rand(*shape).astype(np.float32)
    text_len, query_len = np.array([7, 4]), np.array([9, 5])
    ref = jax_guided_attention_loss(jnp.asarray(attn), jnp.asarray(text_len),
                                    jnp.asarray(query_len), 0.3)
    ours = _guided_attention_loss(torch.as_tensor(attn),
                                  torch.as_tensor(text_len),
                                  torch.as_tensor(query_len), 0.3)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


# ---- one full train step ----------------------------------------------------

def _ar_batch(seed=0, b=2, l=12, t=520, mel_dim=16, frames=(500, 301)):
    """A collated AR batch: the go frame first, lengths rounded up to r,
    stop_token 1.0 past each row's frames; mel bucket ``t`` gives
    T_dec = t/2 - 1 decoder groups."""
    rs = np.random.RandomState(seed)
    text, pos_text = _text(seed, b, l, (l, l - 3))
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    stop = np.ones((b, t), np.float32)
    lengths = [-(-(n + 1) // 2) * 2 for n in frames]
    for i, n in enumerate(frames):
        mel[i, 0] = 0.0
        mel[i, 1:n + 1] = rs.randn(n, mel_dim)
        stop[i, :n + 1] = 0.0
    return dict(text=text, pos_text=pos_text, mel=mel,
                pos_mel=_positions(lengths, t), stop_token=stop)


def _jax_grads(jmodel, variables, batch, r=2):
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    mel = a["mel"]
    b, _, mel_dim = mel.shape
    src_mask, trg_mask = jmasks.create_masks(
        a["pos_text"], a["pos_mel"][:, :-r:r], model="transformer")

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], mel[:, :-r:r], src_mask, trg_mask, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        t = out.mel_pre.shape[1]
        return jax_losses.transformer_tts_loss(
            out.mel_pre.reshape(b, t * r, mel_dim),
            out.mel_post.reshape(b, t * r, mel_dim),
            out.stop_token.reshape(b, t * r), mel[:, r:],
            a["stop_token"][:, r:])[0]
    return jax.grad(loss)(variables["params"])


def test_train_step_matches_jax(monkeypatch):
    calls = _counting(monkeypatch)
    warmup = 10
    hp, jmodel, variables, model = build_ar_pair(warmup_step=warmup)
    jhp = JaxHParams(**dict(CFG, warmup_step=warmup))
    batch = _ar_batch()
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    new_jstate, jlogs = jax_train_step(jmodel, jhp, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    jgrads = state_dict_from_flax(host(_jax_grads(jmodel, variables, batch)),
                                  variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)

    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    old = {k: v.clone() for k, v in model.state_dict().items()}
    state, logs = make_transformer_train_step(hp, device="cpu")(state, batch)
    assert state.step == 1
    # T_dec = 259 >= FLASH_MIN_KEY_LEN: each decoder self-attention takes
    # the causal kernel (K3's plain version here); the 12-token text stays
    # on the masked path
    assert calls == [True] * SMALL["n_layer_decoder"]
    assert sorted(logs) == sorted(jlogs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-8,
                                   err_msg=name)
        # Adam's first step moves each element by lr*g/(|g| + 1e-9):
        # where g is rounding noise around 0 (key biases, biases before a
        # BatchNorm) it is any value in [-lr, lr] in either package
        new, ref = p.detach().numpy(), jnew[name].numpy()
        settled = settled_update(p.grad.numpy(), want, lr)
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        moved = np.abs(new - old[name].numpy())
        ulp = np.spacing(np.abs(old[name].numpy()))
        assert np.all(moved <= lr * 1.0001 + 2 * ulp), name
    for name, value in model.state_dict().items():
        if "running" in name:                    # BatchNorm statistics
            np.testing.assert_allclose(value.numpy(), jnew[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(value, old[name])


def test_guided_attention_puts_every_attention_on_the_masked_path(
        monkeypatch):
    calls = _counting(monkeypatch)
    hp = HParams(**dict(CFG, guided_attention_weight=2.0, warmup_step=10))
    state = init_transformer_state(hp, device="cpu")
    batch = _ar_batch(t=520)
    _, logs = make_transformer_train_step(hp, device="cpu")(state, batch)
    assert calls == []
    total = (logs["loss_frame_before"] + logs["loss_frame_after"]
             + logs["loss_token"] + 2.0 * logs["loss_guided_attention"])
    np.testing.assert_allclose(float(logs["loss_total"]), float(total),
                               rtol=1e-6)


def test_entry_points_default_to_the_card():
    for fn in (init_transformer_state, make_transformer_train_step,
               build_transformer_tts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_transformer_state(HParams(**CFG))


@pytest.mark.parametrize("option", [
    {"decoder_type": "tacotron2"}, {"gst": True},
    {"is_multi_speaker": True, "spk_emb_architecture": "encoder"},
    {"output_type": "softmax"}])
def test_ar_options_of_later_slices_raise(option):
    hp = HParams(**dict(CFG, **option))
    if option == {"gst": True}:
        # GST is ported (tests/test_torch_port_gst.py): the model builds
        # with its style embedding and one train step runs
        state = init_transformer_state(hp, device="cpu")
        assert state.model.style_embedding is not None
        state, logs = make_transformer_train_step(hp, device="cpu")(
            state, _ar_batch(t=40, frames=(30, 21)))
        assert state.step == 1 and np.isfinite(float(logs["loss_total"]))
        return
    if hp.is_multi_speaker:
        # speakers are ported (tests/test_torch_port_speakers_serving.py);
        # without spk_emb_dim there is no table
        with pytest.raises(ValueError, match="spk_emb_dim"):
            build_transformer_tts(hp, device="cpu")
        with pytest.raises(ValueError, match="spk_emb_dim"):
            make_transformer_train_step(hp, device="cpu")
        return
    if hp.output_type:
        # the discrete mode is ported (tests/test_torch_port_discrete.py):
        # the model builds with an embedding prenet; the AR step, which
        # fails in the JAX package, is refused
        model = build_transformer_tts(hp, device="cpu")
        assert isinstance(model.decoder.decoder_prenet.layer["fc1"],
                          torch.nn.Embedding)
        with pytest.raises(ValueError, match="int codes"):
            make_transformer_train_step(hp, device="cpu")
        return
    # the Tacotron 2 decoder is ported (tests/test_torch_port_tacotron2.py):
    # the model builds with it and one train step runs
    state = init_transformer_state(hp, device="cpu")
    assert state.model.stop_token is None
    state, logs = make_transformer_train_step(hp, device="cpu")(
        state, _ar_batch(t=40, frames=(30, 21)))
    assert state.step == 1 and np.isfinite(float(logs["loss_total"]))


# ---- attention dispatch -----------------------------------------------------

def test_attention_dispatch_rules(monkeypatch):
    calls = _counting(monkeypatch)
    t = port_attention.FLASH_MIN_KEY_LEN + 3
    mha = port_attention.MultiHeadAttention(2, 32, dropout=0.0,
                                            use_flash=True).eval()
    x = torch.as_tensor(_features(16, 2, t, 32))
    k_len = torch.tensor([t, 100], dtype=torch.int32)
    trg = masks.create_masks(torch.ones(2, 4, dtype=torch.long),
                             torch.as_tensor(_positions([t, 100], t)),
                             model="transformer")[1]
    with torch.no_grad():
        kernel, _ = mha(x, x, x, trg, k_len=k_len, causal=True)
        assert calls == [True]
        masked, probs = mha(x, x, x, trg, collect_attn=True, k_len=k_len,
                            causal=True)
        assert calls == [True] and probs.shape == (2, 2, t, t)
        # a padded query row sees every valid key on both paths
        _close(kernel, masked)
        with pytest.raises(ValueError, match="causal=True"):
            mha(x, x, x, trg, k_len=k_len)
        steps = t
        cache = tuple(torch.zeros(2, 2, steps, 16) for _ in range(2))
        step_mask = (torch.arange(steps) <= 5)[None, None].expand(2, 1, steps)
        out, _ = mha(x[:, 5:6], x[:, 5:6], x[:, 5:6], step_mask,
                     k_len=k_len, cache=cache, cache_index=torch.tensor([5]))
        assert calls == [True] and out.shape == (2, 1, 32)
        assert cache[0][:, :, 5].any() and not cache[0][:, :, 6:].any()


# ---- converter --------------------------------------------------------------

def test_weight_round_trip(pair):
    hp, _, variables, model = pair
    params, bstats = convert_transformer_state_dict(model.state_dict(), hp)
    assert (jax.tree.structure(params)
            == jax.tree.structure(variables["params"]))
    for got, want in ((params, variables["params"]),
                      (bstats, variables["batch_stats"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    again = state_dict_from_flax(params, bstats, hp)
    for name, value in model.state_dict().items():
        if name in again:
            assert torch.equal(again[name], value), name
    assert set(model.state_dict()) - set(again) <= {
        n for n in model.state_dict() if n.endswith("num_batches_tracked")}


# ---- data -------------------------------------------------------------------

def _corpus(tmp_path, n=6, mel_dim=16, normalise=False):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 14)
        base = tmp_path / f"utt{i}.npy"
        t_mel = 2 * t_text + i % 2
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        # the f0 and energy siblings the default pitch_pred/energy_pred read
        for tail in ("_f0.npy", "_energy.npy"):
            np.save(str(base).replace(".npy", tail),
                    rs.rand(t_mel).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    extra = {}
    if normalise:
        np.save(tmp_path / "mean.npy", rs.randn(mel_dim).astype(np.float32))
        np.save(tmp_path / "var.npy",
                rs.uniform(0.5, 2, mel_dim).astype(np.float32))
        extra = dict(mean_file=str(tmp_path / "mean.npy"),
                     var_file=str(tmp_path / "var.npy"))
    return str(tmp_path / "train.txt"), extra


def test_ar_dataset_and_collate_match_jax(tmp_path):
    script, extra = _corpus(tmp_path, normalise=True)
    cfg = dict(mel_dim=16, model="Transformer", reduction_rate=2,
               text_buckets=(8, 16), length_buckets=(16, 25, 32), **extra)
    ours_ds = TTSDataset(script, HParams(**cfg))
    # as the JAX training CLI reads an AR corpus: no alignment, and the
    # f0 and energy siblings (which the AR step drops)
    ref_ds = JaxTTSDataset(script, JaxHParams(**cfg), alignment_pred=False)
    samples = [ours_ds[i] for i in range(3)]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        np.testing.assert_allclose(s["mel"], r["mel"], rtol=1e-6)
        np.testing.assert_array_equal(s["text"], r["text"])
        assert s["mel_length"] == r["mel_length"]
        assert not s["mel"][0].any()                      # the go frame
        assert s["mel_length"] % 2 == 0 and s["mel_length"] >= len(s["mel"])
        assert "alignment" not in s
    ours = batching.collate(samples, HParams(**cfg), pad_batch=True)
    ref = jax_batching.collate(samples, JaxHParams(**cfg))
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    assert ours["mel"].shape[1] % 2 == 0               # 25 is skipped
    for i, s in enumerate(samples):                    # stop: 1.0 on padding
        assert not ours["stop_token"][i, :len(s["mel"])].any()
        assert ours["stop_token"][i, len(s["mel"]):].all()
    np.testing.assert_array_equal(ours_ds.mel_lengths(),
                                  ref_ds.mel_lengths())


# ---- the CLIs ---------------------------------------------------------------

def test_ar_train_cli_then_synthesis_cli_on_its_checkpoint(tmp_path, capsys):
    script, _ = _corpus(tmp_path)
    cfg = dict(CFG, batch_size=2, max_epoch=1, save_per_epoch=1,
               warmup_step=10, train_script=script,
               save_dir=str(tmp_path / "ckpt"), text_buckets=(8, 16),
               length_buckets=(32, 64))
    hp_path = tmp_path / "hparams.py"
    hp_path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    train_cli.main(["--hp_file", str(hp_path), "--device", "cpu",
                    "--max_steps", "2", "--set", "dropout=0.1"])
    printed = capsys.readouterr().out
    assert "epoch 1 step 1 " in printed and "epoch 1 step 2 " in printed
    assert "loss_token=" in printed and "loss_frame_after=" in printed
    load_dir = os.path.join(cfg["save_dir"], "epoch_1")
    assert sorted(os.listdir(load_dir)) == ["hparams.py", "model.pt",
                                            "train_state.pt"]
    out_dir = tmp_path / "gen"
    synth_cli.main(["--load_name", load_dir, "--test_script", script,
                    "--save", str(out_dir), "--batch_size", "3",
                    "--device", "cpu"])
    for idx in range(6):
        mel = np.load(out_dir / f"{idx}.npy")
        assert mel.shape[1] == 16 and np.isfinite(mel).all()
        assert 0 < mel.shape[0] <= 500 * 2 and mel.shape[0] % 2 == 0
        assert not (out_dir / f"{idx}_alignment.npy").exists()
    assert "elapsed time" in capsys.readouterr().out
