"""The port's speaker, accent and hop-size conditioning of FastSpeech 2, the
variance adaptor's ``use_pos``/``use_rnn_length``, the CTC tap and the SSIM
loss, against the JAX package on the CPU in fp32.

``SpeakerBias`` in both branches (x-vector Linear, speaker-id table); the
eval forward of both stacks with every option at once, for the speaker
architectures ``encoder,middle,decoder`` (x-vectors) and
``encoder,decoder`` (ids), at 1e-4; a conformer that softsigns its raw
``multi_emb`` fails; flax's LSTM cell against ``UniLSTM`` with its gates
carried by ``compat/from_jax``, and a permuted gate order fails;
``ctc_aux_loss`` and ``ssim`` with their gradients, with padded labels and
frames; one multi-speaker train step with CTC and SSIM against JAX's (the
adaptor's fixed 0.1 positional dropout set to 0 on both sides); the data
layer's conditioning against JAX's ``TTSDataset``/``collate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.data import batching as jax_batching
from transformer_tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from transformer_tts_tpu.models import layers as jax_layers
from transformer_tts_tpu.models import variance_adaptor as jax_va
from transformer_tts_tpu.ops.masks import (
    create_masks as jax_create_masks, pad_mask as jax_pad_mask)
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_fastspeech2_train_step as jax_train_step)
from transformer_tts_tpu_torch.compat.from_jax import (
    _Writer, state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.data import batching
from transformer_tts_tpu_torch.data.dataset import ScriptDataset, TTSDataset
from transformer_tts_tpu_torch.models.layers import SpeakerBias
from transformer_tts_tpu_torch.models.variance_adaptor import UniLSTM
from transformer_tts_tpu_torch.ops.masks import pad_mask
from transformer_tts_tpu_torch.train import losses, schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_fastspeech2_train_step)

from torch_port_pair import CONFORMER, SMALL, _random_params, build_pair, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
N_SPEAKERS = 7
# every option of the slice at once, in the two speaker conventions
OPTIONS = dict(use_hop=True, CTC_training=True, use_pos=True,
               use_rnn_length=True, accent_emb=True)
XVECTOR = dict(is_multi_speaker=True, spk_emb_type="x_vector",
               spk_emb_dim=512, spk_emb_architecture="encoder,middle,decoder",
               **OPTIONS)
SPEAKER_ID = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
                  spk_emb_dim=N_SPEAKERS,
                  spk_emb_architecture="encoder,decoder", **OPTIONS)
CASES = {"xvector-transformer": XVECTOR, "id-transformer": SPEAKER_ID,
         "xvector-conformer": dict(XVECTOR, **CONFORMER),
         "id-conformer": dict(SPEAKER_ID, **CONFORMER)}


def _speakers(hp, rs, b):
    if hp.spk_emb_dim == 512:
        return rs.randn(b, 512).astype(np.float32)
    return rs.randint(0, N_SPEAKERS, b).astype(np.int32)


def _inputs(hp, seed=1, b=2, l=12, t=48):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 40, (b, l)).astype(np.int32)
    text[1, l - 3:] = 0
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    d = (rs.randint(0, 5, (b, l)) * (text != 0)).astype(np.int32)
    p = rs.uniform(60, 800, (b, t)).astype(np.float32)
    e = rs.uniform(0, 320, (b, t)).astype(np.float32)
    cond = dict(spk_emb=_speakers(hp, rs, b),
                accent=rs.randint(0, 5, (b, l)).astype(np.int32),
                hop_size=np.array([1, 2], np.int32)[:b])
    return text, pos, t, d, p, e, cond


def _torch_cond(cond):
    return {k: (torch.as_tensor(v) if v.dtype == np.float32
                else torch.as_tensor(v).long()) for k, v in cond.items()}


def _forward_pair(pair):
    hp, jmodel, variables, model = pair
    text, pos, t, d, p, e, cond = _inputs(hp)
    ref = jmodel.apply(variables, jnp.asarray(text),
                       jax_pad_mask(jnp.asarray(pos)), t, jnp.asarray(d),
                       jnp.asarray(p), jnp.asarray(e), train=False,
                       **{k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(),
                     pad_mask(torch.as_tensor(pos)), t, torch.as_tensor(d),
                     torch.as_tensor(p), torch.as_tensor(e),
                     **_torch_cond(cond))
    return ours, ref


# ---- the modules ------------------------------------------------------------

@pytest.mark.parametrize("spk_emb_dim", [512, N_SPEAKERS])
def test_speaker_bias_matches_flax(spk_emb_dim):
    d, b = 16, 3
    rs = np.random.RandomState(spk_emb_dim)
    spk = (rs.randn(b, 512).astype(np.float32) if spk_emb_dim == 512
           else np.array([0, 6, 3], np.int32))
    jmod = jax_layers.SpeakerBias(d, spk_emb_dim)
    params = _random_params(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(spk)))["params"], rs)
    w = _Writer(params, None)
    w.speaker_bias((), "bias", spk_emb_dim)
    ours = SpeakerBias(d, spk_emb_dim)
    ours.load_state_dict({k[len("bias."):]: v for k, v in w.out.items()})
    kind = torch.nn.Linear if spk_emb_dim == 512 else torch.nn.Embedding
    assert isinstance(ours.multi_emb, kind)
    assert ours.speaker_L_l1_es.bias is None
    got = ours(torch.as_tensor(spk) if spk_emb_dim == 512
               else torch.as_tensor(spk).long())
    ref = jmod.apply({"params": params}, jnp.asarray(spk))
    assert got.shape == (b, 1, d)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_with_every_option_matches_jax(case):
    ours, ref = _forward_pair(build_pair(**CASES[case]))
    for name in ("mel_pre", "mel_post", "log_duration", "pitch", "energy",
                 "variance_adaptor_output", "ctc_logits"):
        np.testing.assert_allclose(to_np(getattr(ours, name)),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    assert ours.ctc_logits.shape[-1] == SMALL["vocab_size"]
    np.testing.assert_array_equal(to_np(ours.mel_len),
                                  np.asarray(ref.mel_len))


def test_conditioning_moves_the_output():
    """Each input reaches the mel: another speaker, accent or hop size
    gives another output."""
    hp, _, _, model = build_pair(**SPEAKER_ID)
    text, pos, t, d, p, e, cond = _inputs(hp)
    base = _torch_cond(cond)

    def mel(**change):
        with torch.no_grad():
            return model(torch.as_tensor(text).long(),
                         pad_mask(torch.as_tensor(pos)), t,
                         torch.as_tensor(d), torch.as_tensor(p),
                         torch.as_tensor(e), **dict(base, **change)).mel_post
    ref = mel()
    for key, value in (("spk_emb", (base["spk_emb"] + 1) % N_SPEAKERS),
                       ("accent", (base["accent"] + 1) % 5),
                       ("hop_size", torch.tensor([0, 0]))):
        assert (mel(**{key: value}) - ref).abs().max() > 1e-3, key


def test_softsigned_conformer_speaker_embedding_fails(monkeypatch):
    """The conformer adds its raw ``multi_emb``: a softsign on it (as the
    transformer's ``SpeakerBias`` applies) moves the output past the
    tolerance."""
    class Softsigned(torch.nn.Module):
        def __init__(self, emb):
            super().__init__()
            self.emb = emb

        def forward(self, spk):
            return F.softsign(self.emb(spk))

    pair = build_pair(**CASES["id-conformer"])
    for layer in list(pair[3].encoder.layers) + list(pair[3].decoder.layers):
        monkeypatch.setattr(layer, "multi_emb", Softsigned(layer.multi_emb))
    ours, ref = _forward_pair(pair)
    assert np.abs(to_np(ours.mel_post) - np.asarray(ref.mel_post)).max() \
        > 1e-2


def _lstm_pair(h=16, d_in=12, seed=0):
    jmod = jax_va._UniLSTM(h)
    x = np.random.RandomState(seed).randn(2, 9, d_in).astype(np.float32)
    params = _random_params(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"],
        np.random.RandomState(seed + 1))
    w = _Writer(params, None)
    w.lstm(("OptimizedLSTMCell_0",), "lstm")
    ours = UniLSTM(d_in, h)
    ours.load_state_dict({k[len("lstm."):]: v for k, v in w.out.items()})
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    return ours, torch.as_tensor(x), ref


def test_lstm_gates_match_flax():
    ours, x, ref = _lstm_pair()
    assert set(ours.state_dict()) == {"weight_ih_l0", "weight_hh_l0",
                                      "bias_hh_l0"}
    got = ours(x)
    np.testing.assert_allclose(to_np(got), ref, **TOL)
    # the input bias is no parameter: held at 0, out of the gradient
    got.sum().backward()
    assert not ours.bias_ih_l0.any() and ours.bias_ih_l0.grad is None
    assert ours.bias_hh_l0.grad.abs().max() > 0


@pytest.mark.parametrize("order", [(0, 2, 1, 3), (1, 0, 2, 3)])
def test_permuted_lstm_gates_fail(order):
    ours, x, ref = _lstm_pair()
    h = ours.hidden
    perm = torch.cat([torch.arange(g * h, (g + 1) * h) for g in order])
    with torch.no_grad():
        for p in (ours.weight_ih_l0, ours.weight_hh_l0, ours.bias_hh_l0):
            p.copy_(p[perm].clone())
    assert np.abs(to_np(ours(x)) - ref).max() > 1e-2


# ---- the losses -------------------------------------------------------------

def _ctc_case(seed=0, b=3, t=40, k=12, n_labels=9):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, t, k).astype(np.float32)
    frames = np.array([t, 31, 20])
    label_len = np.array([n_labels, 5, 7])
    labels = np.zeros((b, n_labels), np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rs.randint(1, k, label_len[i])
    return logits, frames, labels, label_len


def _jax_ctc(logits, frames, labels):
    paddings = (np.arange(logits.shape[1])[None] >= frames[:, None])
    return jax_losses.ctc_aux_loss(
        logits, jnp.asarray(paddings.astype(np.float32)),
        jnp.asarray(labels), jnp.asarray((labels == 0).astype(np.float32)))


def test_ctc_aux_loss_and_gradient_match_jax():
    logits, frames, labels, label_len = _ctc_case()
    ref, ref_grad = jax.value_and_grad(
        lambda x: _jax_ctc(x, frames, labels))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.ctc_aux_loss(x, torch.as_tensor(frames),
                              torch.as_tensor(labels),
                              torch.as_tensor(label_len))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-6)
    # frames past each row's length get no gradient
    assert not x.grad[1, 31:].any() and not x.grad[2, 20:].any()


def test_ctc_of_a_row_too_short_for_its_labels():
    """A row with fewer frames than its labels need: torch's CTC gives inf
    (no ``zero_infinity``); optax floors the impossible path at its log
    epsilon and gives a large finite value instead (a stated
    difference)."""
    logits, frames, labels, label_len = _ctc_case()
    frames = np.array([40, 4, 20])
    got = losses.ctc_aux_loss(torch.as_tensor(logits),
                              torch.as_tensor(frames),
                              torch.as_tensor(labels),
                              torch.as_tensor(label_len))
    ref = float(_jax_ctc(jnp.asarray(logits), frames, labels))
    assert got.item() == float("inf")
    assert np.isfinite(ref) and ref > 1e3


def test_ssim_and_gradient_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 30, 16).astype(np.float32)
    y = (0.5 * rs.randn(2, 30, 16) + x).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(
        lambda a: jax_losses.ssim(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = losses.ssim(xt, torch.as_tensor(y))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-7)
    assert float(losses.ssim(torch.as_tensor(y), torch.as_tensor(y))) \
        == pytest.approx(1.0, abs=1e-6)


# ---- one multi-speaker train step -------------------------------------------

STEP_CASES = {"xvector-transformer": dict(XVECTOR, use_ssim=True),
              "id-conformer": dict(CASES["id-conformer"], use_ssim=True)}


def _train_batch(hp, seed=0, b=2, l=12, t=256, mel_dim=16, frames=(10, 22)):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 40, (b, l)).astype(np.int32)
    text[1, l - 3:] = 0
    pos_text = np.where(text != 0, np.arange(1, l + 1)[None],
                        0).astype(np.int32)
    dur = rs.randint(*frames, (b, l)).astype(np.int32) * (text != 0)
    mel_len = dur.sum(1)
    pos_mel = np.where(np.arange(t)[None] < mel_len[:, None],
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    f0 = np.zeros((b, t), np.float32)
    energy = np.zeros((b, t), np.float32)
    for i, n in enumerate(mel_len):
        mel[i, :n] = rs.randn(n, mel_dim)
        f0[i, :n] = rs.uniform(60, 800, n)
        energy[i, :n] = rs.uniform(0, 315, n)
    accent = (rs.randint(0, 5, (b, l)) * (text != 0)).astype(np.int32)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                alignment=dur, f0=f0, energy=energy,
                spk_emb=_speakers(hp, rs, b), accent=accent,
                hop_size=np.array([2, 1], np.int32)[:b])


def _jax_grads(jmodel, variables, batch, jhp):
    """jax.grad of the loss ``make_fastspeech2_train_step`` takes (with
    SSIM and 0.2 x CTC), compiled."""
    t = batch["mel"].shape[1]
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    src_mask, mel_mask = jax_create_masks(a["pos_text"], a["pos_mel"])

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], src_mask, t, a["alignment"], a["f0"], a["energy"],
            mel_mask=mel_mask, accent=a["accent"], spk_emb=a["spk_emb"],
            hop_size=a["hop_size"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        total = jax_losses.fastspeech2_loss(
            out, a["mel"], a["alignment"], a["f0"], a["energy"],
            src_mask=src_mask, mel_mask=mel_mask,
            use_ssim=jhp.use_ssim)[0]
        return total + 0.2 * jax_losses.ctc_aux_loss(
            out.ctc_logits, 1.0 - mel_mask[:, 0, :].astype(jnp.float32),
            a["text"], (a["text"] == 0).astype(jnp.float32))
    return jax.jit(jax.grad(loss))(variables["params"])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_multi_speaker_train_step_matches_jax(case, monkeypatch):
    # the adaptor's positional encoding has a fixed dropout of 0.1: 0 here
    real = jax_va.PositionalEncoder
    monkeypatch.setattr(jax_va, "PositionalEncoder",
                        lambda d, dropout, **kw: real(d, 0.0, **kw))
    warmup = 10
    cfg = dict(STEP_CASES[case], warmup_step=warmup)
    hp, jmodel, variables, model = build_pair(**cfg)
    model.variance_adaptor.pos.dropout.p = 0.0
    jhp = JaxHParams(**dict(SMALL, **cfg))
    batch = _train_batch(hp)
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
    jgrads = state_dict_from_flax(
        host(_jax_grads(jmodel, variables, batch, jhp)),
        variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)

    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    state, logs = make_fastspeech2_train_step(hp, device="cpu")(state,
                                                                  batch)
    assert {"loss_ctc", "loss_ssim"} <= set(logs) and set(jlogs) == set(logs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-4, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0)
    live = ("spk_proj", "hop_emb", "ctc_linear", "acc_embed", "multi_emb",
            "speaker_L_l1_es", "rnn_length", "pos.alpha")
    seen = set()
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        # Adam's first update is lr * g / (|g| + eps), whose slope eps /
        # (|g| + eps)^2 is steep where |g| is small: where the gradients'
        # own difference bounds the updates' within 1e-6, they must agree
        # to 1e-6 (the gradients themselves are held above)
        got = p.grad.numpy()
        diff = np.abs(got - want)
        least = np.maximum(np.abs(want) - diff, 0.0)
        settled = ((np.abs(want) > 1e-7)
                   & (lr * diff * 1e-9 / (least + 1e-9) ** 2 <= 1e-6))
        np.testing.assert_allclose(p.detach().numpy()[settled],
                                   jnew[name].numpy()[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        for part in live:
            if part in name and p.grad.abs().max() > 0:
                seen.add(part)
    arch = set(live) - ({"spk_proj"} if "middle" not in
                        hp.spk_emb_architecture else set())
    arch -= ({"speaker_L_l1_es"} if hp.encoder_type == "conformer"
             else set())
    assert seen >= arch


# ---- the data layer ---------------------------------------------------------

def _corpus(tmp_path, kind, n=5, mel_dim=16):
    """A tiny corpus: ``hop256``/``hop160``/plain mel names, alignment, f0
    and energy siblings, x-vector siblings, column 2 a speaker id
    (speaker_id) or per-phone accents (x_vector), column 3 a gender."""
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 10)
        t_mel = 3 * t_text
        tag = ("hop256", "hop160", "plain")[i % 3]
        base = tmp_path / f"utt{i}_{tag}.npy"
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        for tail, value in (("_alignment", np.full((t_text,), 3, np.int32)),
                            ("_f0", rs.rand(t_mel).astype(np.float32)),
                            ("_energy", rs.rand(t_mel).astype(np.float32)),
                            ("_xvector", rs.randn(512).astype(np.float32))):
            np.save(str(base).replace(".npy", f"{tail}.npy"), value)
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        col2 = (str(i % 2) if kind == "speaker_id"
                else " ".join(str(x) for x in rs.randint(0, 5, t_text)))
        lines.append(f"{base}|{ids}|{col2}|{i % 2}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


@pytest.mark.parametrize("kind", ["speaker_id", "x_vector"])
def test_dataset_and_collate_conditioning_match_jax(tmp_path, kind):
    script = _corpus(tmp_path, kind)
    cfg = dict(mel_dim=16, text_buckets=(8, 16), length_buckets=(16, 32),
               is_multi_speaker=True, spk_emb_type=kind, use_hop=True,
               accent_emb=True, gender_emb=True,
               spk_emb_dim=512 if kind == "x_vector" else 2)
    ours_ds, ref_ds = TTSDataset(script, HParams(**cfg)), \
        JaxTTSDataset(script, JaxHParams(**cfg))
    samples = [ours_ds[i] for i in range(len(ours_ds))]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        for key in ("text", "mel", "alignment", "spk_emb", "accent",
                    "hop_size", "gender"):
            np.testing.assert_array_equal(s[key], r[key], err_msg=key)
    assert [s["hop_size"] for s in samples] == [1, 2, 0, 1, 2]
    ours = batching.collate(samples[:3], HParams(**cfg), pad_batch=True)
    ref = jax_batching.collate(samples[:3], JaxHParams(**cfg))
    for key in ("text", "mel", "alignment", "spk_emb", "accent", "hop_size",
                "gender"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        assert ours[key].dtype == ref[key].dtype, key
    assert ours["spk_emb"].shape[0] == 4 and not ours["spk_emb"][3].any()
    # synthesis samples (JAX's test_mode) keep their conditioning too
    test_ds = JaxTTSDataset(script, JaxHParams(**cfg), test_mode=True)
    for i, s in enumerate(ScriptDataset(script, HParams(**cfg))):
        r = test_ds[i]
        assert "mel" not in s
        for key in ("spk_emb", "accent", "hop_size", "gender"):
            np.testing.assert_array_equal(s[key], r[key], err_msg=key)
        if i == len(test_ds) - 1:
            break
