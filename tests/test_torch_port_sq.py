"""The port's SQ-VAE FastSpeech 2 (models/sq_vae.py, models/fastspeech2_sq.py,
``use_sq_vae`` in models/fastspeech2.py, their losses, train steps and
CLIs) against the JAX package, on the CPU in fp32.

A small model (d 32, 2+2 layers, every dropout 0) on the same weights in
both packages (tests/torch_port_pair.build_pair). The Gumbel noise is the
same on both sides: the JAX module's ``jax.random.gumbel`` is replaced by
a draw from a numpy seed, and the port gets that array (as the codebook's
``gumbel``, or through ``models.sq_vae.gumbel_noise`` in a model). The
codebook at 1e-5, the models at 1e-4, the train step with the FastSpeech 2
step's rules (tests/test_torch_port_train.py).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat.torch_import import (
    convert_sq_fastspeech2_state_dict)
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.models import sq_vae as jax_sq
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_sq_fastspeech2_train_step as jax_sq_step)
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import state_dict_from_flax
from transformer_tts_tpu_torch.compat.torch_import import (
    load_reference_checkpoint)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_fastspeech2)
from transformer_tts_tpu_torch.models import sq_vae
from transformer_tts_tpu_torch.models.fastspeech2_sq import (
    SQFastSpeech2, build_sq_fastspeech2)
from transformer_tts_tpu_torch.ops import masks
from transformer_tts_tpu_torch.train import losses, schedule
from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_fastspeech2_train_step, make_sq_fastspeech2_train_step,
    sq_temperature)

from torch_port_pair import SMALL, build_pair, settled_update, to_np


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
SQ = dict(model="SQFastSpeech2")


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _noise(seed, shape):
    """A Gumbel draw from a numpy seed: -log(-log(U))."""
    u = np.random.RandomState(seed).uniform(1e-6, 1.0, shape)
    return (-np.log(-np.log(u))).astype(np.float32)


def _fixed_jax_noise(monkeypatch, noise):
    """Make the JAX module's Gumbel draw return ``noise``."""
    def gumbel(key, shape, *a, **kw):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise)
    monkeypatch.setattr(jax_sq.jax.random, "gumbel", gumbel)


def _fixed_noise(monkeypatch, noise):
    """Make both packages' Gumbel draws return ``noise``."""
    _fixed_jax_noise(monkeypatch, noise)
    monkeypatch.setattr(sq_vae, "gumbel_noise",
                        lambda shape, device, generator:
                        torch.as_tensor(noise))


@pytest.fixture(scope="module")
def sq_pair():
    return build_pair(**SQ)


def _codebook(seed=0, m=12, d=6):
    rs = np.random.RandomState(seed)
    emb = rs.randn(m, d).astype(np.float32)
    jmod = jax_sq.SQEmbedding(m, d)
    port = sq_vae.SQEmbedding(m, d)
    with torch.no_grad():
        port.embedding.copy_(torch.as_tensor(emb))
    return jmod, {"params": {"embedding": jnp.asarray(emb)}}, port


# ---- the codebook -----------------------------------------------------------

@pytest.mark.parametrize("log_var", [math.log(10.0), -0.7])
def test_encode_matches_jax(log_var):
    jmod, variables, port = _codebook()
    x = np.random.RandomState(1).randn(3, 7, 6).astype(np.float32) * 2
    lv = np.full((1,), log_var, np.float32)
    dist = jmod.apply(variables, jnp.asarray(x.reshape(-1, 6)),
                      jnp.asarray(lv).reshape(1, 1),
                      method=jax_sq.SQEmbedding._distances)
    quant, idx = jmod.apply(variables, jnp.asarray(x), jnp.asarray(lv),
                            method=jax_sq.SQEmbedding.encode)
    with torch.no_grad():
        ours_dist = port.distances(torch.as_tensor(x.reshape(-1, 6)),
                                   torch.as_tensor(lv))
        ours_q, ours_idx = port.encode(torch.as_tensor(x),
                                       torch.as_tensor(lv))
    _close(ours_dist, dist)
    np.testing.assert_array_equal(ours_idx.numpy(), np.asarray(idx))
    _close(ours_q, quant)


@pytest.mark.parametrize("temperature", [1.0, 0.3])
def test_stochastic_call_and_its_gradients_match_jax(monkeypatch,
                                                     temperature):
    jmod, variables, port = _codebook(2)
    x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32)
    lv = np.full((1,), 0.4, np.float32)
    w = np.random.RandomState(4).randn(2, 5, 6).astype(np.float32)
    noise = _noise(5, (10, 12))
    _fixed_jax_noise(monkeypatch, noise)

    def jax_fn(emb, x, lv):
        q, loss, ppl, idx = jmod.apply({"params": {"embedding": emb}}, x, lv,
                                       temperature,
                                       rng=jax.random.PRNGKey(0))
        return jnp.sum(q * w) + loss, (q, loss, ppl, idx)

    (_, (q, loss, ppl, idx)), grads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        variables["params"]["embedding"], jnp.asarray(x), jnp.asarray(lv))
    tx = torch.as_tensor(x).requires_grad_()
    tlv = torch.as_tensor(lv).requires_grad_()
    oq, oloss, oppl, oidx = port(tx, tlv, temperature,
                                 gumbel=torch.as_tensor(noise))
    ((oq * torch.as_tensor(w)).sum() + oloss).backward()
    _close(oq, q)
    _close(oloss, loss)
    _close(oppl, ppl)
    np.testing.assert_array_equal(oidx.numpy(), np.asarray(idx))
    for ours, ref in zip((port.embedding.grad, tx.grad, tlv.grad), grads):
        _close(ours, ref, rtol=1e-4, atol=1e-5)


def test_gumbel_noise_comes_from_the_generator():
    g = torch.Generator().manual_seed(3)
    a = sq_vae.gumbel_noise((40, 9), "cpu", g)
    b = sq_vae.gumbel_noise((40, 9), "cpu", torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert not torch.equal(a, sq_vae.gumbel_noise((40, 9), "cpu", g))


# ---- the models -------------------------------------------------------------

def _text(seed, b=2, l=10, lengths=(10, 7)):
    rs = np.random.RandomState(seed)
    pos = np.where(np.arange(l)[None] < np.array(lengths)[:, None],
                   np.arange(1, l + 1)[None], 0).astype(np.int32)
    text = np.where(pos > 0, rs.randint(1, 40, (b, l)), 0).astype(np.int32)
    return text, pos


def test_sq_eval_forward_and_synthesis_match_jax(sq_pair):
    _, jmodel, variables, model = sq_pair
    text, pos = _text(6)
    t = 48
    ref = jmodel.apply(variables, jnp.asarray(text),
                       jmasks.pad_mask(jnp.asarray(pos)), t, train=False)
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(),
                     masks.pad_mask(torch.as_tensor(pos)), t)
    np.testing.assert_array_equal(ours.mel_len.numpy(),
                                  np.asarray(ref.mel_len))
    assert int(ours.mel_len.min()) > 0
    for name in ("mel_pre", "mel_post", "log_duration", "pitch", "energy",
                 "variance_adaptor_output", "text_dur_predicted"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
    assert ours.sq_vae_loss is None and ref.sq_vae_loss is None
    # synthesize_fastspeech2 runs the same eval forward on an SQ model
    mel, mel_len, dur = synthesize_fastspeech2(
        model, torch.as_tensor(text).long(), torch.as_tensor(pos), t)
    _close(mel, ref.mel_post, **MODEL_TOL)
    want = np.round(np.exp(np.asarray(ref.log_duration)) - 1.0).clip(0)
    np.testing.assert_array_equal(dur.numpy(), np.where(pos > 0, want, 0))


def _train_inputs(seed, t=40):
    text, pos = _text(seed)
    rs = np.random.RandomState(seed + 1)
    pos_mel = np.where(np.arange(t)[None] < np.array([[t], [29]]),
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    f0 = (rs.rand(2, t) * 300 + 60).astype(np.float32) * (pos_mel > 0)
    energy = (rs.rand(2, t) * 100).astype(np.float32) * (pos_mel > 0)
    mel = rs.randn(2, t, 16).astype(np.float32)
    return dict(text=text, pos_text=pos, mel=mel, pos_mel=pos_mel, f0=f0,
                energy=energy, alignment=np.where(pos > 0, 3, 0).astype(
                    np.int32))


@pytest.mark.parametrize("targets", [False, True])
def test_sq_train_forward_matches_jax(sq_pair, monkeypatch, targets):
    # without a duration target x and z are both expanded by the predicted
    # durations; with one (the targets' case) x alone, by the target
    _, jmodel, variables, model = sq_pair
    batch = _train_inputs(7)
    _fixed_noise(monkeypatch, _noise(8, (20, 128)))
    temp = 0.9
    jsrc, jmel = jmasks.create_masks(jnp.asarray(batch["pos_text"]),
                                     jnp.asarray(batch["pos_mel"]))
    src, mel_mask = masks.create_masks(torch.as_tensor(batch["pos_text"]),
                                       torch.as_tensor(batch["pos_mel"]))
    d = batch["alignment"] if targets else None
    ref, _ = jmodel.apply(
        variables, jnp.asarray(batch["text"]), jsrc, 40,
        None if d is None else jnp.asarray(d), jnp.asarray(batch["f0"]),
        jnp.asarray(batch["energy"]), jmel, temperature=temp, train=True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    model.train()
    try:
        ours = model(torch.as_tensor(batch["text"]).long(), src, 40,
                     None if d is None else torch.as_tensor(d),
                     torch.as_tensor(batch["f0"]),
                     torch.as_tensor(batch["energy"]), mel_mask,
                     temperature=temp)
    finally:
        model.eval()
    for name in ("mel_pre", "mel_post", "log_duration", "pitch", "energy",
                 "sq_vae_loss", "sq_vae_perplexity"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
    np.testing.assert_array_equal(ours.mel_len.numpy(),
                                  np.asarray(ref.mel_len))
    assert torch.equal(ours.mel_mask, mel_mask)     # the caller's, as is


def _sq_batch(seed=0, b=2, l=12, t=300):
    """A collated batch whose mel bucket puts the decoder on K1-d/K2's
    path (T >= 256)."""
    rs = np.random.RandomState(seed)
    text, pos = _text(seed, b, l, (l, l - 3))
    frames = np.array([[t], [t - 40]])
    pos_mel = np.where(np.arange(t)[None] < frames,
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    valid = pos_mel > 0
    return dict(text=text, pos_text=pos,
                mel=np.where(valid[..., None], rs.randn(b, t, 16), -5.0)
                .astype(np.float32), pos_mel=pos_mel,
                f0=(rs.rand(b, t) * 300 + 60).astype(np.float32) * valid,
                energy=(rs.rand(b, t) * 100).astype(np.float32) * valid)


def _jax_sq_grads(jmodel, variables, batch, temp):
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    src_mask, mel_mask = jmasks.create_masks(a["pos_text"], a["pos_mel"])

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], src_mask, a["mel"].shape[1], None, a["f0"],
            a["energy"], mel_mask=mel_mask, temperature=temp, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        pred = jnp.sum(jnp.exp(out.log_duration) * src_mask[:, 0, :], 1)
        lens = jnp.sum(mel_mask[:, 0, :], 1).astype(jnp.float32)
        return (jax_losses.mse_loss_arelbo(out.mel_pre, a["mel"])
                + jax_losses.l1(out.mel_post, a["mel"])
                + jnp.mean(jnp.abs(pred - lens))
                + jax_losses.l1(out.pitch, a["f0"])
                + jax_losses.l1(out.energy, a["energy"]) + out.sq_vae_loss)
    return jax.jit(jax.grad(loss))(variables["params"])


def test_sq_train_step_matches_jax(monkeypatch):
    warmup, k = 10, 30000        # temperature exp(-0.3) at step k
    hp, jmodel, variables, model = build_pair(warmup_step=warmup, **SQ)
    jhp = JaxHParams(**dict(SMALL, warmup_step=warmup, **SQ))
    batch = _sq_batch()
    _fixed_noise(monkeypatch, _noise(9, (24, 128)))
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.asarray(k, jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    new_jstate, jlogs = jax_sq_step(jmodel, jhp, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    temp = math.exp(-1e-5 * k)
    assert sq_temperature(k) == pytest.approx(temp)
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    jgrads = state_dict_from_flax(
        host(_jax_sq_grads(jmodel, variables, batch, temp)),
        variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)

    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    state = TrainState(model, opt, torch.Generator().manual_seed(0), step=k)
    old = {n: v.clone() for n, v in model.state_dict().items()}
    state, logs = make_sq_fastspeech2_train_step(hp, device="cpu")(state,
                                                                   batch)
    assert state.step == k + 1
    assert sorted(logs) == sorted(jlogs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(hp.d_model_decoder, hp.warmup_factor,
                                warmup)(0)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = float(np.abs(want).max())
        if name.startswith(("variance_adaptor.codebook",
                            "variance_adaptor.log_var_q",
                            "variance_adaptor.duration_predictor.linear")):
            assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-8, err_msg=name)
        new, ref = p.detach().numpy(), jnew[name].numpy()
        settled = settled_update(p.grad.numpy(), want, lr)
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        moved = np.abs(new - old[name].numpy())
        ulp = np.spacing(np.abs(old[name].numpy()))
        assert np.all(moved <= lr * 1.0001 + 2 * ulp), name
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), jnew[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(value, old[name]), name


def test_use_sq_vae_fastspeech2_forward_and_loss_match_jax(monkeypatch):
    hp, jmodel, variables, model = build_pair(use_sq_vae=True)
    assert model.codebook is not None
    batch = _train_inputs(10)
    _fixed_noise(monkeypatch, _noise(11, (20, 128)))
    temp = sq_temperature(5000)
    jsrc, jmel = jmasks.create_masks(jnp.asarray(batch["pos_text"]),
                                     jnp.asarray(batch["pos_mel"]))
    src, mel_mask = masks.create_masks(torch.as_tensor(batch["pos_text"]),
                                       torch.as_tensor(batch["pos_mel"]))
    args = [batch[k] for k in ("alignment", "f0", "energy")]
    for train in (False, True):
        ref = jmodel.apply(
            variables, jnp.asarray(batch["text"]), jsrc, 40,
            *map(jnp.asarray, args), mel_mask=jmel, temperature=temp,
            train=train, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])[0]
        model.train(train)
        with torch.set_grad_enabled(train):
            ours = model(torch.as_tensor(batch["text"]).long(), src, 40,
                         *map(torch.as_tensor, args), mel_mask,
                         temperature=temp)
        for name in ("mel_pre", "mel_post", "log_duration", "pitch"):
            _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
        if not train:
            assert ours.sq_vae_loss is None
            continue
        _, jlogs = jax_losses.fastspeech2_loss(
            ref, jnp.asarray(batch["mel"]), *map(jnp.asarray, args),
            src_mask=jsrc, mel_mask=jmel, use_sq_vae=True)
        _, logs = losses.fastspeech2_loss(
            ours, torch.as_tensor(batch["mel"]), *map(torch.as_tensor, args),
            src_mask=src, mel_mask=mel_mask, use_sq_vae=True)
        assert sorted(logs) == sorted(jlogs)
        for key, value in jlogs.items():
            np.testing.assert_allclose(float(logs[key]), float(value),
                                       rtol=1e-5, err_msg=key)
    model.eval()


def test_use_sq_vae_train_step_anneals_the_temperature(monkeypatch):
    hp = HParams(**dict(SMALL, use_sq_vae=True, warmup_step=10))
    _, _, _, model = build_pair(use_sq_vae=True)
    seen = []
    real = sq_vae.SQEmbedding.forward

    def recording(self, x, log_var_q, temperature, **kw):
        seen.append(temperature)
        return real(self, x, log_var_q, temperature, **kw)

    monkeypatch.setattr(sq_vae.SQEmbedding, "forward", recording)
    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    state = TrainState(model, opt, torch.Generator().manual_seed(0), step=7)
    batch = _train_inputs(12)
    step = make_fastspeech2_train_step(hp, device="cpu")
    for _ in range(2):
        state, logs = step(state, batch)
    assert seen == [sq_temperature(7), sq_temperature(8)]
    assert {"sq_vae_loss", "sq_vae_perplexity"} <= set(logs)


def test_reference_sq_state_dict_loads_strictly(sq_pair, tmp_path):
    hp, jmodel, _, model = sq_pair
    path = tmp_path / "network.epoch3"
    torch.save(model.state_dict(), path)
    params, bstats = convert_sq_fastspeech2_state_dict(
        torch.load(path), JaxHParams(**dict(SMALL, **SQ)))
    loaded = load_reference_checkpoint(str(path), hp, device="cpu")
    assert isinstance(loaded, SQFastSpeech2)
    text, pos = _text(13)
    ref = jmodel.apply({"params": params, "batch_stats": bstats},
                       jnp.asarray(text), jmasks.pad_mask(jnp.asarray(pos)),
                       48, train=False)
    with torch.no_grad():
        ours = loaded(torch.as_tensor(text).long(),
                      masks.pad_mask(torch.as_tensor(pos)), 48)
    _close(ours.mel_post, ref.mel_post, **MODEL_TOL)


# ---- the CLIs ---------------------------------------------------------------

def _corpus(tmp_path, n=4, mel_dim=16):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 10)
        base = tmp_path / f"utt{i}.npy"
        np.save(base, rs.randn(3 * t_text, mel_dim).astype(np.float32))
        np.save(tmp_path / f"utt{i}_alignment.npy",
                np.full((t_text,), 3, np.int32))
        np.save(tmp_path / f"utt{i}_f0.npy",
                (rs.rand(3 * t_text) * 300 + 60).astype(np.float32))
        np.save(tmp_path / f"utt{i}_energy.npy",
                (rs.rand(3 * t_text) * 100).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


def _write_hp(tmp_path, **extra):
    cfg = dict(SMALL, batch_size=2, max_epoch=1, save_per_epoch=1,
               warmup_step=10, train_script=_corpus(tmp_path),
               save_dir=str(tmp_path / "ckpt"), text_buckets=(8, 16),
               length_buckets=(32,), **extra)
    path = tmp_path / "hparams.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path), cfg["save_dir"]


@pytest.mark.parametrize("name", ["SQFastSpeech2", "fastspeech2_sq"])
def test_sq_train_cli_takes_a_step(tmp_path, capsys, name):
    hp_path, save_dir = _write_hp(tmp_path, model=name)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "1"])
    printed = capsys.readouterr().out
    assert "epoch 1 step 1 " in printed and "sq_vae_loss=" in printed
    state = torch.load(os.path.join(save_dir, "epoch_1", "model.pt"))
    assert "variance_adaptor.codebook.embedding" in state


def test_synthesis_cli_refuses_sq_hparams(tmp_path):
    hp_path, save_dir = _write_hp(tmp_path, **SQ)
    model = build_sq_fastspeech2(HParams(**dict(SMALL, **SQ)), device="cpu")
    save_checkpoint(model, os.path.join(save_dir, "epoch_1"))
    os.replace(hp_path, os.path.join(save_dir, "hparams.py"))
    with pytest.raises(ValueError, match="SQ-VAE"):
        synth_cli.main(["--load_name", save_dir, "--save",
                        str(tmp_path / "out"), "--device", "cpu"])
