"""The port's discrete output mode (``output_type = "softmax"``), the LSTM
language model, the modules that no model builds (``EncoderPreNet``,
``Aligner``, ``EncoderPostprocessing``), the SQ-VAE FastSpeech 2's
speakers and accents and the AR data's f0/energy siblings, against the
JAX package on the CPU in fp32.

Tolerances as tests/test_torch_port_train.py and test_torch_port_ar.py:
losses at 1e-5 relative, modules at 1e-5, models at 1e-4, one train step
with gradients at 1e-4 of their scale and Adam's first update exact where
the gradient is above rounding noise. The discrete codes are two streams
of C classes (here C = 8, ``mel_dim`` 16) padded with 320; the JAX AR
step fails in this mode, and the port's refuses it.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformer_tts_tpu.models.sq_vae as jax_sq
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.data import batching as jax_batching
from transformer_tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from transformer_tts_tpu.models.decoder import Decoder as JaxDecoder
from transformer_tts_tpu.models.encoder import (
    EncoderPostprocessing as JaxEncoderPostprocessing)
from transformer_tts_tpu.models.lm import (
    LSTMLanguageModel as JaxLSTMLanguageModel)
from transformer_tts_tpu.models.prenets import (
    DecoderPreNet as JaxDecoderPreNet, EncoderPreNet as JaxEncoderPreNet)
from transformer_tts_tpu.models.transformer_tts import (
    build_transformer_tts as jax_build_transformer_tts)
from transformer_tts_tpu.models.variance_adaptor import (
    Aligner as JaxAligner)
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_fastspeech2_train_step as jax_fs2_step,
    make_sq_fastspeech2_train_step as jax_sq_step,
    make_transformer_train_step as jax_ar_step)
from transformer_tts_tpu_torch.compat.from_jax import (
    _Writer, aligner_state_dict_from_flax,
    encoder_postprocessing_state_dict_from_flax,
    encoder_prenet_state_dict_from_flax, lm_state_dict_from_flax,
    state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.data import batching
from transformer_tts_tpu_torch.data.dataset import TTSDataset
from transformer_tts_tpu_torch.infer.synthesize import synthesize_fastspeech2
from transformer_tts_tpu_torch.models import sq_vae
from transformer_tts_tpu_torch.models.decoder import Decoder
from transformer_tts_tpu_torch.models.encoder import EncoderPostprocessing
from transformer_tts_tpu_torch.models.fastspeech2_sq import (
    build_sq_fastspeech2)
from transformer_tts_tpu_torch.models.lm import (
    LSTMLanguageModel, build_lstm_language_model)
from transformer_tts_tpu_torch.models.prenets import (
    DecoderPreNet, EncoderPreNet)
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)
from transformer_tts_tpu_torch.models.variance_adaptor import Aligner
from transformer_tts_tpu_torch.ops import masks
from transformer_tts_tpu_torch.train import losses, schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, init_transformer_state, make_fastspeech2_train_step,
    make_sq_fastspeech2_train_step, make_transformer_train_step)

from torch_port_pair import (
    AR, SMALL, _random_params, build_pair, settled_update, to_np)


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
SOFTMAX = dict(output_type="softmax")       # mel_dim 16: 2 streams of 8
PAD = 320


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _codes(rs, b, t, lengths, classes=8):
    """(B, T, 2) int32 codes, 320 past each row's length."""
    codes = rs.randint(0, classes, (b, t, 2)).astype(np.int32)
    for i, n in enumerate(lengths):
        codes[i, n:] = PAD
    return codes


def _text(seed, b=2, l=10, lengths=(10, 7)):
    rs = np.random.RandomState(seed)
    pos = np.where(np.arange(l)[None] < np.asarray(lengths)[:b, None],
                   np.arange(1, l + 1)[None], 0).astype(np.int32)
    text = np.where(pos > 0, rs.randint(1, 40, (b, l)), 0).astype(np.int32)
    return text, pos


def _assert_step_matches(model, jgrads, jnew, old, clip, lr):
    """The AR/FastSpeech 2 tests' rules for one train step."""
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = float(np.abs(want).max())
        if scale <= 1e-7:           # 0 in exact arithmetic: rounding noise
            assert float(p.grad.abs().max()) <= 1e-7, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-4 * scale + 1e-8,
                                       err_msg=name)
        new, ref = p.detach().numpy(), jnew[name].numpy()
        settled = settled_update(p.grad.numpy(), want, lr)
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        moved = np.abs(new - old[name].numpy())
        ulp = np.spacing(np.abs(old[name].numpy()))
        assert np.all(moved <= lr * 1.0001 + 2 * ulp), name


def _jax_state(jhp, variables, step=0):
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    return JaxTrainState(
        step=jnp.asarray(step, jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)


def _port_state(hp, model, step=0):
    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return TrainState(model, opt, torch.Generator().manual_seed(0), step)


# ---- the discrete loss ------------------------------------------------------

@pytest.mark.parametrize("classes", [8, 320])
def test_softmax_output_loss_matches_jax(classes):
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 12, 2 * classes).astype(np.float32) * 3
    codes = _codes(rs, 2, 12, (12, 7), classes)
    ref, ref_acc = jax_losses.softmax_output_loss(
        jnp.asarray(logits), jnp.asarray(codes), classes)
    ours, acc = losses.softmax_output_loss(
        torch.as_tensor(logits), torch.as_tensor(codes), classes)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    for key in ("accuracy_1", "accuracy_2"):
        np.testing.assert_allclose(float(acc[key]), float(ref_acc[key]),
                                   rtol=1e-6)
    # the padded tail counts nowhere: changing its logits changes nothing
    logits[1, 7:] += 5.0
    again, _ = losses.softmax_output_loss(
        torch.as_tensor(logits), torch.as_tensor(codes), classes)
    np.testing.assert_allclose(float(again), float(ours), rtol=1e-6)


def test_fastspeech2_loss_in_the_discrete_mode_matches_jax():
    rs = np.random.RandomState(1)
    b, t, l = 2, 20, 6
    arrays = dict(mel_pre=rs.randn(b, t, 16), mel_post=rs.randn(b, t, 16),
                  log_duration=rs.randn(b, l), pitch=rs.randn(b, t),
                  energy=rs.randn(b, t))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    codes = _codes(rs, b, t, (t, 13))
    d = rs.randint(0, 5, (b, l))
    f0, energy = rs.rand(b, t).astype(np.float32), \
        rs.rand(b, t).astype(np.float32)
    _, ref = jax_losses.fastspeech2_loss(
        types.SimpleNamespace(sq_vae_loss=None, **{
            k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(codes), jnp.asarray(d), jnp.asarray(f0),
        jnp.asarray(energy), output_type="softmax")
    _, ours = losses.fastspeech2_loss(
        types.SimpleNamespace(sq_vae_loss=None, **{
            k: torch.as_tensor(v) for k, v in arrays.items()}),
        torch.as_tensor(codes), torch.as_tensor(d), torch.as_tensor(f0),
        torch.as_tensor(energy), output_type="softmax")
    assert sorted(ours) == sorted(ref)
    assert {"accuracy_1", "accuracy_2", "loss_duration", "loss_f0",
            "loss_energy"} <= set(ours)
    for key in ref:
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)


def _softmax_batch(seed=0, b=2, l=10, t=40):
    rs = np.random.RandomState(seed)
    text, pos_text = _text(seed, b, l, (l, l - 3))
    dur = (rs.randint(2, 5, (b, l)) * (text != 0)).astype(np.int32)
    mel_len = dur.sum(1)
    pos_mel = np.where(np.arange(t)[None] < mel_len[:, None],
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    valid = pos_mel > 0
    return dict(text=text, pos_text=pos_text,
                mel=_codes(rs, b, t, mel_len), pos_mel=pos_mel,
                alignment=dur,
                f0=(rs.uniform(60, 800, (b, t)) * valid).astype(np.float32),
                energy=(rs.uniform(0, 315, (b, t)) * valid).astype(
                    np.float32))


def test_softmax_train_step_matches_jax():
    """One discrete-mode FastSpeech 2 step, codes padded with 320 past
    each row's frames."""
    warmup = 10
    hp, jmodel, variables, model = build_pair(warmup_step=warmup, **SOFTMAX)
    jhp = JaxHParams(**dict(SMALL, warmup_step=warmup, **SOFTMAX))
    batch = _softmax_batch()
    assert (batch["mel"] == PAD).any()
    new_jstate, jlogs = jax_fs2_step(jmodel, jhp, donate=False)(
        _jax_state(jhp, variables),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    src_mask, mel_mask = jmasks.create_masks(a["pos_text"], a["pos_mel"])

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], src_mask, 40, a["alignment"], a["f0"], a["energy"],
            mel_mask=mel_mask, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_losses.fastspeech2_loss(
            out, a["mel"], a["alignment"], a["f0"], a["energy"],
            output_type="softmax")[0]
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    grads = jax.jit(jax.grad(loss))(variables["params"])
    jgrads = state_dict_from_flax(host(grads),
                                  variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)
    state = _port_state(hp, model)
    old = {k: v.clone() for k, v in model.state_dict().items()}
    state, logs = make_fastspeech2_train_step(hp, device="cpu")(state, batch)
    assert sorted(logs) == sorted(jlogs) and "accuracy_2" in logs
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    _assert_step_matches(
        model, jgrads, jnew, old, min(1.0, 1.0 / float(jlogs["grad_norm"])),
        schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0))
    model.eval()


# ---- the discrete AR input --------------------------------------------------

def test_embed_prenet_and_the_decoder_sum_match_jax():
    rs = np.random.RandomState(3)
    codes = rs.randint(0, 16, (2, 7, 2)).astype(np.int32)
    jpre = JaxDecoderPreNet(16, 32, output_type=True)
    pshapes = jax.eval_shape(lambda: jpre.init(
        jax.random.PRNGKey(0), jnp.asarray(codes), train=False))
    pparams = _random_params(pshapes["params"], rs)
    pre = DecoderPreNet(16, 32, output_type=True).eval()
    pre.load_state_dict({
        "layer.fc1.weight": torch.as_tensor(pparams["fc1"]["embedding"]),
        "layer.fc2.weight": torch.as_tensor(pparams["fc2"]["kernel"].T),
        "layer.fc2.bias": torch.as_tensor(pparams["fc2"]["bias"])})
    ref = jpre.apply({"params": pparams}, jnp.asarray(codes), train=False)
    with torch.no_grad():
        ours = pre(torch.as_tensor(codes).long())
    assert ours.shape == (2, 7, 2, 32)
    _close(ours, ref)
    # the decoder sums the two streams after the prenet
    jdec = JaxDecoder(16, 32, 2, 2, 1, dropout=0.0, dropout_prenet=0.0,
                      output_type=True)
    e = rs.randn(2, 9, 32).astype(np.float32)
    src = jmasks.pad_mask(jnp.ones((2, 9), jnp.int32))
    _, trg_mask = jmasks.create_masks(jnp.ones((2, 9), jnp.int32),
                                      jnp.ones((2, 7), jnp.int32),
                                      model="transformer")
    dshapes = jax.eval_shape(lambda: jdec.init(
        jax.random.PRNGKey(0), jnp.asarray(codes), jnp.asarray(e), src,
        trg_mask, train=False))
    dparams = _random_params(dshapes["params"], rs)
    writer = _Writer({"decoder": dparams}, None)
    writer.ar_decoder(2, None, output_type=True)
    state = {k[len("decoder."):]: v for k, v in writer.out.items()}
    dec = Decoder(16, 32, 2, 2, 1, dropout=0.0, dropout_prenet=0.0,
                  output_type=True).eval()
    dec.load_state_dict(state)
    ref, _, _ = jdec.apply({"params": dparams}, jnp.asarray(codes),
                           jnp.asarray(e), src, trg_mask, train=False)
    with torch.no_grad():
        ours, _, _ = dec(torch.as_tensor(codes).long(), torch.as_tensor(e),
                         masks.pad_mask(torch.ones(2, 9)),
                         torch.as_tensor(np.array(trg_mask)))
    _close(ours, ref, **MODEL_TOL)


def test_discrete_ar_model_runs_and_its_step_is_refused_as_jax_fails():
    """The AR model's discrete forward matches JAX's; JAX's AR step fails
    on its reshape (float frames against int codes), so the port's step
    maker raises ``ValueError`` naming that cause."""
    cfg = dict(SMALL, **AR, **SOFTMAX)
    jmodel = jax_build_transformer_tts(JaxHParams(**cfg))
    text, pos = _text(4, l=8, lengths=(8, 6))
    codes = _codes(np.random.RandomState(4), 2, 6, (6, 6), 16)
    pos_mel = np.tile(np.arange(1, 7)[None], (2, 1))
    jsrc, jtrg = jmasks.create_masks(jnp.asarray(pos), jnp.asarray(pos_mel),
                                     model="transformer")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(codes), jsrc,
        jtrg, train=False))
    rs = np.random.RandomState(5)
    variables = {"params": _random_params(shapes["params"], rs),
                 "batch_stats": _random_params(shapes["batch_stats"], rs)}
    hp = HParams(**cfg)
    model = build_transformer_tts(hp, device="cpu").eval()
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], hp))
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(codes),
                       jsrc, jtrg, train=False)
    src, trg = masks.create_masks(torch.as_tensor(pos),
                                  torch.as_tensor(pos_mel),
                                  model="transformer")
    with torch.no_grad():
        out = model(torch.as_tensor(text).long(),
                    torch.as_tensor(codes).long(), src, trg)
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(out, name), getattr(ref, name), **MODEL_TOL)
    batch = dict(text=jnp.asarray(text), pos_text=jnp.asarray(pos),
                 mel=jnp.asarray(_codes(rs, 2, 16, (16, 12), 16)),
                 pos_mel=jnp.tile(jnp.arange(1, 17)[None], (2, 1)),
                 stop_token=jnp.zeros((2, 16)))
    with pytest.raises(TypeError, match="reshape"):
        jax_ar_step(jmodel, JaxHParams(**cfg), donate=False)(
            _jax_state(JaxHParams(**cfg), variables), batch,
            jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="int codes"):
        make_transformer_train_step(hp, device="cpu")
    assert init_transformer_state(hp, device="cpu").model.decoder.output_type


# ---- data -------------------------------------------------------------------

def _token_corpus(tmp_path, n=5, ar=False):
    """(T, 2) int code files with alignment, f0 and energy siblings."""
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(3, 7)
        t = 3 * t_text + (1 if ar else 0)
        base = str(tmp_path / f"utt{i}.npy")
        np.save(base, rs.randint(0, 320, (t, 2)).astype(np.int64))
        np.save(base.replace(".npy", "_alignment.npy"),
                np.full((t_text,), 3, np.int32))
        np.save(base.replace(".npy", "_f0.npy"),
                rs.rand(t).astype(np.float32))
        np.save(base.replace(".npy", "_energy.npy"),
                rs.rand(t).astype(np.float32))
        lines.append(f"{base}|{' '.join(map(str, rs.randint(1, 40, t_text)))}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


@pytest.mark.parametrize("model", ["FastSpeech2", "Transformer"])
def test_token_dataset_and_collate_match_jax(tmp_path, model):
    script = _token_corpus(tmp_path, ar=model == "Transformer")
    cfg = dict(mel_dim=640, model=model, reduction_rate=2, text_buckets=(8,),
               length_buckets=(16, 24), **SOFTMAX)
    ours_ds = TTSDataset(script, HParams(**cfg))
    is_ar = model == "Transformer"
    ref_ds = JaxTTSDataset(script, JaxHParams(**cfg),
                           alignment_pred=not is_ar)
    samples = [ours_ds[i] for i in range(4)]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        assert sorted(s) == sorted(r)
        assert s["mel"].dtype == np.int32 and s["mel"].shape[1] == 2
        for key in ("mel", "text", "f0", "energy"):
            np.testing.assert_array_equal(s[key], r[key], err_msg=key)
        assert s["mel_length"] == r["mel_length"] == len(s["mel"])
    ours = batching.collate(samples, HParams(**cfg))
    ref = jax_batching.collate(samples, JaxHParams(**cfg))
    assert ours["mel"].dtype == np.int32
    assert (ours["mel"] == PAD).any()
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    np.testing.assert_array_equal(ours_ds.mel_lengths(),
                                  ref_ds.mel_lengths())


def test_ar_data_reads_f0_and_energy_siblings_as_jax(tmp_path):
    """An AR corpus with ``pitch_pred``/``energy_pred`` (the defaults)
    loads f0 and energy as the JAX training CLI's dataset does; the AR
    step ignores them."""
    rs = np.random.RandomState(1)
    lines = []
    for i in range(3):
        base = str(tmp_path / f"utt{i}.npy")
        t = 9 + i
        np.save(base, rs.randn(t, 16).astype(np.float32))
        np.save(base.replace(".npy", "_f0.npy"), rs.rand(t).astype(
            np.float32))
        np.save(base.replace(".npy", "_energy.npy"), rs.rand(t).astype(
            np.float32))
        lines.append(f"{base}|{' '.join(map(str, rs.randint(1, 40, 5)))}")
    script = tmp_path / "train.txt"
    script.write_text("\n".join(lines) + "\n")
    cfg = dict(SMALL, **AR, text_buckets=(8,), length_buckets=(16,))
    ours_ds = TTSDataset(str(script), HParams(**cfg))
    ref_ds = JaxTTSDataset(str(script), JaxHParams(**cfg),
                           alignment_pred=False)
    samples = [ours_ds[i] for i in range(3)]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        assert sorted(s) == sorted(r) and "f0" in s and "alignment" not in s
        for key in ("mel", "f0", "energy"):
            np.testing.assert_array_equal(s[key], r[key], err_msg=key)
    ours = batching.collate(samples, HParams(**cfg), pad_batch=True)
    ref = jax_batching.collate(samples, JaxHParams(**cfg))
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    hp = HParams(**cfg)
    state = init_transformer_state(hp, device="cpu")
    _, logs = make_transformer_train_step(hp, device="cpu")(state, ours)
    _, logs_without = make_transformer_train_step(hp, device="cpu")(
        init_transformer_state(hp, device="cpu"),
        {k: v for k, v in ours.items() if k not in ("f0", "energy")})
    assert float(logs["loss_total"]) == float(logs_without["loss_total"])


# ---- the language model -----------------------------------------------------

def test_lstm_language_model_matches_jax():
    jlm = JaxLSTMLanguageModel(vocab_size=12, hidden_size=16, num_layers=2)
    rs = np.random.RandomState(6)
    t1, t2 = rs.randint(0, 12, (2, 2, 9))
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.PRNGKey(0), jnp.asarray(t1), jnp.asarray(t2)))
    params = _random_params(shapes["params"], rs)
    ref1, ref2 = jlm.apply({"params": params}, jnp.asarray(t1),
                           jnp.asarray(t2))
    lm = LSTMLanguageModel(12, 16, 2).eval()
    lm.load_state_dict(lm_state_dict_from_flax(params, 2))
    with torch.no_grad():
        out1, out2 = lm(torch.as_tensor(t1), torch.as_tensor(t2))
    assert out1.shape == (2, 9, 12)
    _close(out1, ref1, **MODEL_TOL)
    _close(out2, ref2, **MODEL_TOL)
    # the defaults: hidden 512, 4 layers, vocab 320; the input biases
    # stay outside the state_dict
    lm = build_lstm_language_model(device="cpu")
    assert len(lm.lstms) == 4 and lm.out1.weight.shape == (320, 512)
    assert not any("bias_ih" in k for k in lm.state_dict())


# ---- the modules that no model builds ---------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_encoder_prenet_matches_jax(train):
    jpre = JaxEncoderPreNet(vocab_size=20, d_model=16, dropout=0.0)
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 20, (2, 11))
    shapes = jax.eval_shape(lambda: jpre.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(ids), train=False))
    params = _random_params(shapes["params"], rs)
    bstats = _random_params(shapes["batch_stats"], rs)
    out = jpre.apply({"params": params, "batch_stats": bstats},
                     jnp.asarray(ids), train=train,
                     mutable=["batch_stats"] if train else False)
    ref = out[0] if train else out
    pre = EncoderPreNet(20, 16, dropout=0.0).train(train)
    pre.load_state_dict(encoder_prenet_state_dict_from_flax(params, bstats))
    with torch.no_grad():
        ours = pre(torch.as_tensor(ids))
    _close(ours, ref)
    if train:                  # BatchNorm's statistics move as flax's
        for i in range(3):
            _close(pre.batch_norms[i].running_mean,
                   out[1]["batch_stats"][f"batch_norm_{i + 1}"]["mean"])


def test_aligner_matches_jax():
    jal = JaxAligner(d_model=16, max_duration=10, dropout=0.0)
    rs = np.random.RandomState(8)
    x = rs.randn(2, 6, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda: jal.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    params = _random_params(shapes["params"], rs)
    al = Aligner(16, 10, dropout=0.0).eval()
    al.load_state_dict(aligner_state_dict_from_flax(params))
    ref = jal.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = al(torch.as_tensor(x))
    _close(ours, ref)
    # train mode adds N(0, 1) noise to the logits, from the generator
    al.train()
    with torch.no_grad():
        a = al(torch.as_tensor(x), generator=torch.Generator().manual_seed(0))
        b = al(torch.as_tensor(x), generator=torch.Generator().manual_seed(0))
        c = al(torch.as_tensor(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 6, 10) and 0 <= float(a.min()) and float(
        a.max()) <= 1
    logit = lambda p: torch.log(p) - torch.log1p(-p)  # noqa: E731
    noise = logit(a.double()) - logit(ours.double())
    assert abs(float(noise.std()) - 1.0) < 0.3


@pytest.mark.parametrize("embedding", [True, False])
def test_encoder_postprocessing_matches_jax(embedding):
    kw = dict(vocab_size=16, d_model=16, n_layers=3, heads=2,
              ff_kernel_size=3, embedding=embedding, accent_emb=True,
              gender_emb=True, speaker_emb=True, n_speakers=5,
              ctc_out=True, ctc_classes=20, dropout=0.0)
    jenc = JaxEncoderPostprocessing(**kw)
    rs = np.random.RandomState(9)
    src = (rs.randint(0, 16, (2, 10)) if embedding
           else rs.randn(2, 10, 16).astype(np.float32))
    mask = jnp.asarray(np.arange(10)[None, None] < np.array([[[10]], [[7]]]))
    spk, gender = np.array([0, 3]), np.array([0, 1])
    accent = rs.randint(0, 5, (2, 10))
    args = (jnp.asarray(src), mask, jnp.asarray(spk), jnp.asarray(accent),
            jnp.asarray(gender))
    shapes = jax.eval_shape(lambda: jenc.init(
        {"params": jax.random.PRNGKey(0)}, *args, train=False))
    params = _random_params(shapes["params"], rs)
    ref_x, ref_ctc, _ = jenc.apply({"params": params}, *args, train=False)
    enc = EncoderPostprocessing(**kw).eval()
    enc.load_state_dict(encoder_postprocessing_state_dict_from_flax(
        params, 3, embedding=embedding))
    with torch.no_grad():
        x, ctc, attn = enc(torch.as_tensor(src), torch.as_tensor(
            np.asarray(mask)), torch.as_tensor(spk), torch.as_tensor(accent),
            torch.as_tensor(gender), collect_attn=True)
    _close(x, ref_x, **MODEL_TOL)
    _close(ctc, ref_ctc, **MODEL_TOL)
    assert ctc.shape == (2, 10, 20) and attn.shape == (2, 3, 2, 10, 10)
    with pytest.raises(ValueError, match="gender"):
        enc(torch.as_tensor(src), torch.as_tensor(np.asarray(mask)),
            torch.as_tensor(spk), None, None)


# ---- the SQ-VAE FastSpeech 2's speakers and accents -------------------------

SQ_SPEAKERS = dict(model="SQFastSpeech2", is_multi_speaker=True,
                   spk_emb_type="speaker_id", spk_emb_dim=12,
                   spk_emb_architecture="encoder,decoder", accent_emb=True)


def _fixed_noise(monkeypatch, noise):
    def gumbel(key, shape, *a, **kw):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise)
    monkeypatch.setattr(jax_sq.jax.random, "gumbel", gumbel)
    monkeypatch.setattr(sq_vae, "gumbel_noise",
                        lambda shape, device, generator:
                        torch.as_tensor(noise))


def _sq_batch(seed=0, b=2, l=10, t=40):
    rs = np.random.RandomState(seed)
    text, pos = _text(seed, b, l, (l, l - 3))
    pos_mel = np.where(np.arange(t)[None] < np.array([[t], [29]]),
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    valid = pos_mel > 0
    return dict(text=text, pos_text=pos,
                mel=np.where(valid[..., None], rs.randn(b, t, 16), -5.0)
                .astype(np.float32), pos_mel=pos_mel,
                f0=(rs.rand(b, t) * 300 + 60).astype(np.float32) * valid,
                energy=(rs.rand(b, t) * 100).astype(np.float32) * valid,
                spk_emb=np.array([3, 11], np.int32),
                accent=(rs.randint(0, 5, (b, l)) * (pos > 0)).astype(
                    np.int32))


def test_sq_speakers_and_accents_forward_matches_jax():
    hp, jmodel, variables, model = build_pair(**SQ_SPEAKERS)
    assert model.encoder.acc_embed is not None
    assert model.encoder.layers[0].spk_bias is not None
    assert model.decoder.layers[0].spk_bias is not None
    batch = _sq_batch(1)
    src = jmasks.pad_mask(jnp.asarray(batch["pos_text"]))
    ref = jmodel.apply(variables, jnp.asarray(batch["text"]), src, 40,
                       accent=jnp.asarray(batch["accent"]),
                       spk_emb=jnp.asarray(batch["spk_emb"]), train=False)
    cond = dict(spk_emb=torch.as_tensor(batch["spk_emb"]),
                accent=torch.as_tensor(batch["accent"]))
    with torch.no_grad():
        ours = model(torch.as_tensor(batch["text"]).long(),
                     masks.pad_mask(torch.as_tensor(batch["pos_text"])), 40,
                     **cond)
    for name in ("mel_pre", "mel_post", "log_duration", "pitch", "energy"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
    # the speakers change the output; synthesize_fastspeech2 passes them
    mel, _, _ = synthesize_fastspeech2(
        model, torch.as_tensor(batch["text"]).long(),
        torch.as_tensor(batch["pos_text"]), 40, **cond)
    _close(mel, ref.mel_post, **MODEL_TOL)
    other, _, _ = synthesize_fastspeech2(
        model, torch.as_tensor(batch["text"]).long(),
        torch.as_tensor(batch["pos_text"]), 40,
        spk_emb=torch.tensor([4, 4]), accent=cond["accent"])
    assert not torch.equal(other, mel)


def test_sq_speakers_and_accents_train_step_matches_jax(monkeypatch):
    warmup, k = 10, 30000
    hp, jmodel, variables, model = build_pair(warmup_step=warmup,
                                              **SQ_SPEAKERS)
    jhp = JaxHParams(**dict(SMALL, warmup_step=warmup, **SQ_SPEAKERS))
    batch = _sq_batch()
    _fixed_noise(monkeypatch, np.random.RandomState(9).gumbel(
        size=(20, 128)).astype(np.float32))
    new_jstate, jlogs = jax_sq_step(jmodel, jhp, donate=False)(
        _jax_state(jhp, variables, k),
        {key: jnp.asarray(v) for key, v in batch.items()},
        jax.random.PRNGKey(0))
    a = {key: jnp.asarray(v) for key, v in batch.items()}
    src_mask, mel_mask = jmasks.create_masks(a["pos_text"], a["pos_mel"])
    temp = math.exp(-1e-5 * k)

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], src_mask, 40, None, a["f0"], a["energy"],
            mel_mask=mel_mask, accent=a["accent"], spk_emb=a["spk_emb"],
            temperature=temp, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        pred = jnp.sum(jnp.exp(out.log_duration) * src_mask[:, 0, :], 1)
        lens = jnp.sum(mel_mask[:, 0, :], 1).astype(jnp.float32)
        return (jax_losses.mse_loss_arelbo(out.mel_pre, a["mel"])
                + jax_losses.l1(out.mel_post, a["mel"])
                + jnp.mean(jnp.abs(pred - lens))
                + jax_losses.l1(out.pitch, a["f0"])
                + jax_losses.l1(out.energy, a["energy"]) + out.sq_vae_loss)
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    grads = jax.jit(jax.grad(loss))(variables["params"])
    jgrads = state_dict_from_flax(host(grads),
                                  variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)
    state = _port_state(hp, model, k)
    old = {n: v.clone() for n, v in model.state_dict().items()}
    state, logs = make_sq_fastspeech2_train_step(hp, device="cpu")(state,
                                                                   batch)
    assert sorted(logs) == sorted(jlogs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    grads = dict(model.named_parameters())
    for name in ("encoder.acc_embed.weight",
                 "encoder.layers.0.spk_bias.multi_emb.weight",
                 "decoder.layers.1.spk_bias.speaker_L_l1_es.weight"):
        assert float(grads[name].grad.abs().max()) > 0, name
    _assert_step_matches(
        model, jgrads, jnew, old, min(1.0, 1.0 / float(jlogs["grad_norm"])),
        schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0))
    model.eval()


@pytest.mark.parametrize("option", [
    dict(is_multi_speaker=True, spk_emb_type="x_vector", spk_emb_dim=512,
         spk_emb_architecture="middle"),
    dict(use_hop=True), dict(CTC_training=True), dict(use_pos=True),
    dict(use_rnn_length=True)])
def test_sq_options_that_jax_ignores_raise(option):
    hp = HParams(**dict(SMALL, model="SQFastSpeech2", **option))
    with pytest.raises(ValueError, match="ignores"):
        build_sq_fastspeech2(hp, device="cpu")
