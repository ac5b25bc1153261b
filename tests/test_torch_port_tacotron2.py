"""The port's Tacotron 2 decoder (models/tacotron2_decoder.py,
``decoder_type = "tacotron2"`` of the AR Transformer-TTS) against the JAX
package, on the CPU in fp32.

A small model (d 32, so LSTM cells 128 wide and gates 512; r 2; every
dropout 0) on the same weights in both packages
(tests/torch_port_pair.build_ar_pair). The teacher-forced forward in eval
and train mode and ``synthesize_tacotron2`` (the stop rule firing, and
not) at 1e-4, as the AR model's tests; one full train step with the AR
step's rules (loss at 1e-5 relative, gradients at 1e-4 of their scale,
Adam's first update exact where the gradient is above rounding noise).
JAX's zoneout would draw from its dropout key, which torch cannot
reproduce: the train-mode comparisons swap JAX's decoder for a subclass
with ``zoneout_rate`` 0 (``TransformerTTS.setup`` imports it at call
time) and set the port's to 0; zoneout itself is held to its rate and to
its one mask for c and h. The synthesis loop in blocks of 1 and of 8,
and its CUDA-graph class on the CPU (a fake graph that replays the
captured steps), equal the eager loop bit for bit. The reference
checkpoint map, int8's leaves, the speaker options and both CLIs.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformer_tts_tpu.models.tacotron2_decoder as jax_taco
from transformer_tts_tpu.compat.torch_import import (
    convert_transformer_state_dict)
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.infer.synthesize import (
    synthesize_tacotron2 as jax_synthesize)
from transformer_tts_tpu.models.transformer_tts import (
    build_transformer_tts as jax_build_transformer_tts)
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_transformer_train_step as jax_train_step)
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import (
    flax_layouts, state_dict_from_flax)
from transformer_tts_tpu_torch.compat.torch_import import (
    load_reference_checkpoint)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer import synthesize as synth
from transformer_tts_tpu_torch.models.tacotron2_decoder import (
    Tacotron2Decoder, gate_sigmoid)
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)
from transformer_tts_tpu_torch.ops import masks
from transformer_tts_tpu_torch.train import schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, init_transformer_state, make_transformer_train_step)

from test_torch_port_quantize import SMALL_LEAF, _assert_same_as_jax
from torch_port_pair import AR, SMALL, build_ar_pair, settled_update, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TACO = dict(decoder_type="tacotron2")
CFG = dict(SMALL, **AR, **TACO)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 24                  # synthesis budget in frame groups


@pytest.fixture(scope="module")
def pair():
    return build_ar_pair(**TACO)


class _NoZoneout(jax_taco.Tacotron2Decoder):
    zoneout_rate: float = 0.0


@pytest.fixture()
def no_zoneout(monkeypatch):
    """JAX's decoder without zoneout (it draws from the dropout key)."""
    monkeypatch.setattr(jax_taco, "Tacotron2Decoder", _NoZoneout)


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or MODEL_TOL))


def _text(seed, b=2, l=8, lengths=(8, 5)):
    rs = np.random.RandomState(seed)
    pos = np.where(np.arange(l)[None] < np.asarray(lengths)[:b, None],
                   np.arange(1, l + 1)[None], 0).astype(np.int32)
    text = np.where(pos > 0, rs.randint(1, 40, (b, l)), 0).astype(np.int32)
    return text, pos


def _set_stop_bias(variables, model, bias):
    variables["params"]["decoder"]["TokenProj"]["bias"][:] = bias
    with torch.no_grad():
        model.decoder.TokenProj.bias.fill_(bias)


# ---- the model --------------------------------------------------------------

def test_model_builds_no_out_or_stop_head(pair):
    _, _, variables, model = pair
    assert model.out is None and model.stop_token is None
    assert isinstance(model.decoder, Tacotron2Decoder)
    assert "out" not in variables["params"]
    w = model.decoder.AttentionConv.weight
    assert w.shape == (32, 1, 31) and model.decoder.AttentionConv.bias is None
    # 4 x d wide cells: gates of 16 x d
    assert model.decoder.L_l1_ss.weight.shape == (16 * 32, 4 * 32)


@pytest.mark.parametrize("train", [False, True])
def test_teacher_forced_forward_matches_jax(pair, no_zoneout, train):
    _, jmodel, variables, model = pair
    text, pos = _text(1)
    mel = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    src_mask, _ = jmasks.create_masks(jnp.asarray(pos), None,
                                      model="transformer")
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(mel),
                       src_mask, None, train=train,
                       rngs={"dropout": jax.random.PRNGKey(0)},
                       mutable=["batch_stats"] if train else False)
    ref = ref[0] if train else ref
    sm, _ = masks.create_masks(torch.as_tensor(pos), None,
                               model="transformer")
    model.train(train)
    model.decoder.zoneout_rate = 0.0
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            out = model(torch.as_tensor(text).long(), torch.as_tensor(mel),
                        sm, None, generator=torch.Generator().manual_seed(0))
    finally:
        model.load_state_dict(state)
        model.decoder.zoneout_rate = 0.1
        model.eval()
    assert out.mel_pre.shape == (2, 8, 32)
    assert out.stop_token.shape == (2, 8, 2)
    assert out.attn_dec_dec is None and out.attn_dec_enc.shape == (2, 8, 8)
    for name in ("mel_pre", "mel_post", "stop_token", "attn_dec_enc"):
        _close(getattr(out, name), getattr(ref, name))
    # training alignments: the max is subtracted and no text mask applied
    # (row 1 has 5 phones of 8), yet each row sums to 1
    alpha = to_np(out.attn_dec_enc)
    assert alpha[1, :, 5:].max() > 0
    np.testing.assert_allclose(alpha.sum(-1), 1.0, rtol=1e-5)


def test_teacher_frames_are_the_last_of_the_previous_group(pair):
    """Step 0 reads zeros, step i the last frame of group i - 1: changing
    the final frame of the last group changes nothing, changing the last
    frame of group 0 changes step 1 on."""
    _, _, _, model = pair
    text, pos = _text(1)
    sm = masks.pad_mask(torch.as_tensor(pos))
    mel = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        base = model(torch.as_tensor(text).long(), mel, sm, None).mel_pre
        late = mel.clone()
        late[:, -1] += 1.0
        assert torch.equal(model(torch.as_tensor(text).long(), late, sm,
                                 None).mel_pre, base)
        early = mel.clone()
        early[:, 1] += 1.0                    # the last frame of group 0
        moved = model(torch.as_tensor(text).long(), early, sm, None).mel_pre
    assert torch.equal(moved[:, 0], base[:, 0])
    assert not torch.equal(moved[:, 1], base[:, 1])


# ---- synthesis --------------------------------------------------------------

@pytest.mark.parametrize("stop_bias", [4.0, -4.0])
def test_synthesize_matches_jax(pair, stop_bias):
    """A stop-token bias of 4 fires the stop rule at step 11 (length 15
    groups after the 4-step tail); -4 never does (alignment permitting),
    and the loop runs its budget."""
    _, jmodel, variables, model = pair
    _set_stop_bias(variables, model, stop_bias)
    text, pos = _text(4)
    rs = np.random.RandomState(5)
    mean, var = rs.randn(16).astype(np.float32), \
        rs.uniform(0.5, 2, 16).astype(np.float32)
    ref_mel, ref_len = jax_synthesize(
        jmodel, variables, jnp.asarray(text), jnp.asarray(pos),
        mean=jnp.asarray(mean), var=jnp.asarray(var), max_steps=STEPS)
    mel, lengths = synth.synthesize_tacotron2(
        model, torch.as_tensor(text).long(), torch.as_tensor(pos),
        torch.as_tensor(mean), torch.as_tensor(var), max_steps=STEPS)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert mel.shape == (2, STEPS * 2, 16) and mel.dtype == torch.float32
    _close(mel, ref_mel)
    if stop_bias > 0:
        assert lengths.tolist() == [30, 30]      # (11 + 4) groups x r
    n = int(lengths[0])
    assert not mel[:, n:].any() and mel[:, :n].abs().min() > 0


@pytest.mark.parametrize("steps", [STEPS, 21])
def test_blocks_of_one_and_eight_are_equal(pair, monkeypatch, steps):
    """The host's ``done`` check every step (JAX's loop) or every 8 steps
    gives the same carry: the steps past the stop change no length, no
    frame before it, and never pass ``max_steps``."""
    _, _, variables, model = pair
    _set_stop_bias(variables, model, 4.0)
    text, pos = _text(6)
    out = {}
    for every in (1, 8):
        monkeypatch.setattr(synth, "DONE_CHECK_EVERY", every)
        out[every] = synth.synthesize_tacotron2(
            model, torch.as_tensor(text).long(), torch.as_tensor(pos),
            max_steps=steps)
    assert torch.equal(out[1][1], out[8][1])
    assert torch.equal(out[1][0], out[8][0])


class _FakeGraph:
    """A CUDA graph on the CPU: the capture records each step with the
    carry it ran on; a replay runs them again on the same tensors."""

    def __init__(self):
        self.steps = []

    def replay(self):
        for args in self.steps:
            _REAL_STEP(*args)

    def pool(self):
        return None


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


_REAL_STEP = Tacotron2Decoder.synthesis_step


def test_graph_replays_each_calls_inputs(pair, monkeypatch):
    """``_Tacotron2Graph`` (captured once, on the first call's inputs)
    equals the eager loop on later calls' encoder outputs and masks: the
    static inputs are loaded and the carry reset before every decode."""
    capturing = []

    @contextlib.contextmanager
    def graph(g, pool=None):
        capturing.append(g)
        try:
            yield
        finally:
            capturing.pop()

    def recording(self, *args):
        if capturing:
            capturing[-1].steps.append((self, *args))
        return _REAL_STEP(self, *args)

    monkeypatch.setattr(Tacotron2Decoder, "synthesis_step", recording)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    _, _, variables, model = pair
    _set_stop_bias(variables, model, 0.0)
    dec = model.decoder
    graph_obj = None
    with torch.inference_mode():
        for seed, lengths in ((7, (8, 5)), (8, (6, 8)), (9, (3, 2))):
            text, pos = _text(seed, lengths=lengths)
            sm = masks.pad_mask(torch.as_tensor(pos))
            e, _ = model.encode(torch.as_tensor(text).long(), sm)
            proj = dec.AttentionEncoderProj(e)
            e_mask = sm[:, 0, :].float()
            if graph_obj is None:
                graph_obj = synth._Tacotron2Graph(model, e, proj, e_mask, 21)
                assert sorted(graph_obj.graphs) == [5, 8]
            got = graph_obj.decode(e, proj, e_mask)
            ref = synth.tacotron2_decode(model, e, sm[:, 0, :].sum(-1), 21,
                                         eager=True)
            for key, value in ref.items():
                assert torch.equal(got[key], value), key


# ---- training ---------------------------------------------------------------

def _taco_batch(seed=0, b=2, l=8, t=32, mel_dim=16, frames=(29, 17)):
    """A collated AR batch (the go frame first, lengths rounded up to r,
    stop 1.0 past each row's frames): the decoder runs (t - 2) / 2 = 15
    steps."""
    rs = np.random.RandomState(seed)
    text, pos_text = _text(seed, b, l, (l, l - 3))
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    stop = np.ones((b, t), np.float32)
    pos_mel = np.zeros((b, t), np.int32)
    for i, n in enumerate(frames):
        mel[i, 0] = 0.0
        mel[i, 1:n + 1] = rs.randn(n, mel_dim)
        stop[i, :n + 1] = 0.0
        length = -(-(n + 1) // 2) * 2
        pos_mel[i, :length] = np.arange(1, length + 1)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                stop_token=stop)


def _jax_grads(jmodel, variables, batch, r=2):
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    mel = a["mel"]
    b, _, mel_dim = mel.shape
    src_mask, _ = jmasks.create_masks(a["pos_text"], None,
                                      model="transformer")

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], mel[:, r:], src_mask, None, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        t = out.mel_pre.shape[1]
        return jax_losses.transformer_tts_loss(
            out.mel_pre.reshape(b, t * r, mel_dim),
            out.mel_post.reshape(b, t * r, mel_dim),
            out.stop_token.reshape(b, t * r), mel[:, r:],
            a["stop_token"][:, r:])[0]
    return jax.grad(loss)(variables["params"])


def test_train_step_matches_jax(no_zoneout):
    warmup = 10
    hp, jmodel, variables, model = build_ar_pair(warmup_step=warmup, **TACO)
    model.decoder.zoneout_rate = 0.0
    jhp = JaxHParams(**dict(CFG, warmup_step=warmup))
    batch = _taco_batch()
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
    grads = jax.jit(lambda v: _jax_grads(jmodel, v, batch))(variables)
    jgrads = state_dict_from_flax(host(grads), variables["batch_stats"], hp)
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
    assert sorted(logs) == sorted(jlogs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = float(np.abs(want).max())
        if scale <= 1e-7:
            # 0 in exact arithmetic (the postnet's conv bias before its
            # BatchNorm): rounding noise in both packages
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
    for name, value in model.state_dict().items():
        if "running" in name:                    # the postnet's BatchNorm
            np.testing.assert_allclose(value.numpy(), jnew[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_zoneout_keeps_a_tenth_under_one_mask_for_c_and_h():
    dec = Tacotron2Decoder(8, 16, dropout_prenet=0.5, zoneout_rate=0.1)
    gen = torch.Generator().manual_seed(0)
    masks_ = dec.train_masks(200, 4, "cpu", gen)
    zone = torch.stack([masks_.zoneout1, masks_.zoneout2]).float()
    assert zone.shape == (2, 200, 4, 64)
    assert abs(float(zone.mean()) - 0.1) < 0.005
    pre = masks_.prenet1
    assert pre.shape == (4, 200, 16)
    assert set(pre.unique().tolist()) == {0.0, 2.0}
    assert abs(float((pre > 0).float().mean()) - 0.5) < 0.01
    # the two cells and the steps draw apart
    assert not torch.equal(masks_.zoneout1[0], masks_.zoneout2[0])
    assert not torch.equal(masks_.zoneout1[0], masks_.zoneout1[1])
    # one mask for c and h: where it keeps, both are the old state
    rs = torch.Generator().manual_seed(1)
    rec = torch.randn(4, 256, generator=rs)
    s_prev, c_prev = torch.randn(4, 64, generator=rs), \
        torch.randn(4, 64, generator=rs)
    keep = masks_.zoneout1[0]
    h, c = dec._cell(rec, s_prev, c_prev, keep)
    h0, c0 = dec._cell(rec, s_prev, c_prev, None)
    assert torch.equal(h[keep], s_prev[keep]) and torch.equal(c[keep],
                                                               c_prev[keep])
    assert torch.equal(h[~keep], h0[~keep]) and torch.equal(c[~keep],
                                                            c0[~keep])
    i, f, g, o = rec.chunk(4, -1)
    torch.testing.assert_close(c0, torch.sigmoid(f) * c_prev
                               + torch.sigmoid(i) * torch.tanh(g))
    torch.testing.assert_close(gate_sigmoid(o), torch.sigmoid(o))


def test_train_forward_draws_its_masks_from_the_generator(pair):
    _, _, _, model = pair
    text, pos = _text(1)
    sm = masks.pad_mask(torch.as_tensor(pos))
    mel = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(3))
    model.decoder.dropout_prenet = 0.5
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    try:
        model.train()
        with torch.no_grad():
            for seed in (0, 0, 1):
                outs.append(model(torch.as_tensor(text).long(), mel, sm,
                                  None,
                                  generator=torch.Generator().manual_seed(
                                      seed)).mel_pre)
                model.load_state_dict(state)     # BatchNorm statistics
    finally:
        model.decoder.dropout_prenet = 0.0
        model.eval()
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    assert torch.isfinite(outs[2]).all()


# ---- speakers ---------------------------------------------------------------

def test_decoder_speakers_fail_in_jax_and_are_refused():
    spk = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
               spk_emb_dim=12, spk_emb_architecture="encoder,decoder")
    jhp = JaxHParams(**dict(CFG, **spk))
    jmodel = jax_build_transformer_tts(jhp)
    text, pos = _text(1)
    src_mask, _ = jmasks.create_masks(jnp.asarray(pos), None,
                                      model="transformer")
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(text), jnp.zeros((2, 8, 16)),
            src_mask, None, jnp.zeros((2,), jnp.int32), train=False))
    with pytest.raises(ValueError, match="speaker_L_l1_es"):
        build_transformer_tts(HParams(**dict(CFG, **spk)), device="cpu")


@pytest.mark.parametrize("spk", [
    dict(spk_emb_type="x_vector", spk_emb_dim=512, spk_emb_vers=2),
    dict(spk_emb_type="speaker_id", spk_emb_dim=12,
         spk_emb_architecture="encoder")])
def test_speaker_conditioned_forward_and_synthesis_match_jax(spk):
    """The speakers JAX's Tacotron 2 model takes: ``spk_proj`` of the
    x-vector (spk_emb_vers 2) or per-layer encoder speakers."""
    hp, jmodel, variables, model = build_ar_pair(
        is_multi_speaker=True, **TACO, **spk)
    text, pos = _text(2)
    ids = np.array([3, 7]) if spk["spk_emb_dim"] == 12 else \
        np.random.RandomState(0).randn(2, 512).astype(np.float32)
    mel = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    src_mask, _ = jmasks.create_masks(jnp.asarray(pos), None,
                                      model="transformer")
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(mel),
                       src_mask, None, jnp.asarray(ids), train=False)
    with torch.no_grad():
        out = model(torch.as_tensor(text).long(), torch.as_tensor(mel),
                    masks.pad_mask(torch.as_tensor(pos)), None,
                    spk_emb=torch.as_tensor(ids))
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(out, name), getattr(ref, name))
    ref_mel, ref_len = jax_synthesize(jmodel, variables, jnp.asarray(text),
                                      jnp.asarray(pos), jnp.asarray(ids),
                                      max_steps=16)
    mel_s, lengths = synth.synthesize_tacotron2(
        model, torch.as_tensor(text).long(), torch.as_tensor(pos),
        spk_emb=torch.as_tensor(ids), max_steps=16)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    _close(mel_s, ref_mel)


# ---- checkpoints, int8, the transformer decode ------------------------------

def test_reference_checkpoint_maps_as_jax_maps_it(pair, tmp_path):
    """A reference torch checkpoint (the port's names, DataParallel's
    ``module.`` prefix) loads into the port; the JAX package's
    ``convert_transformer_state_dict`` (``_map_tacotron2_decoder``) maps
    the same file onto its tree; both forwards agree."""
    hp, jmodel, _, model = pair
    path = tmp_path / "network.epoch3"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)
    loaded = load_reference_checkpoint(str(path), hp, device="cpu")
    state = torch.load(path, weights_only=True)
    params, bstats = convert_transformer_state_dict(
        state, JaxHParams(**CFG))
    w = params["decoder"]["AttentionConv"]["kernel"]
    assert w.shape == (31, 1, 32) and "bias" not in params["decoder"][
        "AttentionConv"]
    text, pos = _text(3)
    mel = np.random.RandomState(4).randn(2, 12, 16).astype(np.float32)
    src_mask, _ = jmasks.create_masks(jnp.asarray(pos), None,
                                      model="transformer")
    ref = jmodel.apply({"params": params, "batch_stats": bstats},
                       jnp.asarray(text), jnp.asarray(mel), src_mask, None,
                       train=False)
    with torch.no_grad():
        out = loaded(torch.as_tensor(text).long(), torch.as_tensor(mel),
                     masks.pad_mask(torch.as_tensor(pos)), None)
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(out, name), getattr(ref, name))


def test_q_and_s_equal_jax_for_every_tacotron2_leaf(pair):
    hp, _, variables, _ = pair
    params, bstats = variables["params"], variables["batch_stats"]
    n, _, _, _ = _assert_same_as_jax(
        params, lambda tree: state_dict_from_flax(tree, bstats, hp),
        flax_layouts(hp), SMALL_LEAF)
    assert n > 0
    assert "decoder.L_l1_ss.weight" in flax_layouts(hp)


def test_transformer_decode_refuses_tacotron2(pair):
    _, _, _, model = pair
    with pytest.raises(ValueError, match="synthesize_tacotron2"):
        synth.synthesize_transformer_tts(
            model, torch.ones(1, 4, dtype=torch.long),
            torch.arange(1, 5)[None])


# ---- the CLIs ---------------------------------------------------------------

def _corpus(tmp_path, n=4, mel_dim=16):
    """AR utterances with the f0 and energy siblings that the default
    ``pitch_pred``/``energy_pred`` read."""
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 8)
        t_mel = 2 * t_text + 3
        base = str(tmp_path / f"utt{i}.npy")
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        np.save(base.replace(".npy", "_f0.npy"),
                rs.rand(t_mel).astype(np.float32))
        np.save(base.replace(".npy", "_energy.npy"),
                rs.rand(t_mel).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


def test_train_cli_then_synthesis_cli_on_its_checkpoint(tmp_path, capsys):
    script = _corpus(tmp_path)
    cfg = dict(CFG, batch_size=2, max_epoch=1, save_per_epoch=1,
               warmup_step=10, train_script=script,
               save_dir=str(tmp_path / "ckpt"), text_buckets=(8,),
               length_buckets=(32,))
    hp_path = tmp_path / "hparams.py"
    hp_path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    train_cli.main(["--hp_file", str(hp_path), "--device", "cpu",
                    "--max_steps", "2", "--set", "dropout_prenet=0.5"])
    printed = capsys.readouterr().out
    assert "epoch 1 step 2 " in printed and "loss_token=" in printed
    load_dir = os.path.join(cfg["save_dir"], "epoch_1")
    state = torch.load(os.path.join(load_dir, "model.pt"))
    assert "decoder.L_l1_ys.weight" in state and "out.weight" not in state
    out_dir = tmp_path / "gen"
    synth_cli.main(["--load_name", load_dir, "--test_script", script,
                    "--save", str(out_dir), "--batch_size", "2",
                    "--device", "cpu"])
    lengths = []
    for idx in range(4):
        mel = np.load(out_dir / f"{idx}.npy")
        assert mel.shape[1] == 16 and np.isfinite(mel).all()
        lengths.append(mel.shape[0])
        assert not (out_dir / f"{idx}_alignment.npy").exists()
    # one length per batch (the stop rule reads row 0), at most the budget
    assert lengths[0] == lengths[1] and lengths[2] == lengths[3]
    assert all(0 < n <= 2 * 500 and n % 2 == 0 for n in lengths)
    assert "elapsed time" in capsys.readouterr().out


def test_init_state_builds_the_tacotron2_model():
    state = init_transformer_state(HParams(**CFG), device="cpu")
    assert isinstance(state.model.decoder, Tacotron2Decoder)
    assert state.model.decoder.zoneout_rate == 0.1
