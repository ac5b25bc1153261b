"""The port's FastSpeech 2 training slice against the JAX package, on the CPU
in fp32.

One full train step against ``make_fastspeech2_train_step`` (every dropout
0, the same weights through ``state_dict_from_flax``, a mel bucket of 256
so that the decoder takes the kernels' plain versions): the loss, every
gradient, the updated parameters, the BatchNorm statistics. Beside it the
losses, the Noam schedule, Adam with clipping and accumulation against
``build_optimizer``, BatchNorm's train-mode statistics, scheduled
sampling, the reference init, the data layer, checkpoints and the training
CLI with the synthesis CLI on its checkpoint.
"""

import copy
import inspect
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.data import batching as jax_batching
from transformer_tts_tpu.data import sampler as jax_sampler
from transformer_tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from transformer_tts_tpu.ops.masks import create_masks as jax_create_masks
from transformer_tts_tpu.train import checkpoint as jax_checkpoint
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_fastspeech2_train_step as jax_train_step)
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import state_dict_from_flax
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.data import batching, sampler
from transformer_tts_tpu_torch.data.dataset import TTSDataset
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops.feedforward import batch_norm
from transformer_tts_tpu_torch.ops.masks import create_masks
from transformer_tts_tpu_torch.train import checkpoint, losses, schedule
from transformer_tts_tpu_torch.train import trainer as trainer_module
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, init_fastspeech2_state, init_transformer_state,
    make_fastspeech2_train_step, make_transformer_train_step)

from torch_port_pair import SMALL, build_pair, settled_update, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


# ---- losses -----------------------------------------------------------------

def _outputs(seed, b=2, t=20, mel_dim=16, l=6):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    arrays = dict(mel_pre=f(b, t, mel_dim), mel_post=f(b, t, mel_dim),
                  log_duration=f(b, l), pitch=200 + 50 * f(b, t),
                  energy=100 + 30 * f(b, t))
    pos_text = np.where(np.arange(l)[None] < np.array([[l], [l - 2]]),
                        np.arange(1, l + 1)[None], 0).astype(np.int32)
    pos_mel = np.where(np.arange(t)[None] < np.array([[t], [t - 7]]),
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    targets = dict(mel=f(b, t, mel_dim), d=rs.randint(0, 5, (b, l)),
                   f0=rs.uniform(60, 400, (b, t)).astype(np.float32),
                   energy=rs.uniform(0, 200, (b, t)).astype(np.float32))
    return arrays, targets, pos_text, pos_mel


@pytest.mark.parametrize("options", [
    {}, {"masked": True}, {"channel_wise": True, "channel_weight": (0.5, 2.)},
    {"f0_stats": (200.0, 50.0), "energy_stats": (100.0, 30.0)}])
def test_fastspeech2_loss_matches_jax(options):
    arrays, targets, pos_text, pos_mel = _outputs(0)
    j_src, j_mel = jax_create_masks(jnp.asarray(pos_text),
                                    jnp.asarray(pos_mel))
    src, mel_mask = create_masks(torch.as_tensor(pos_text),
                                 torch.as_tensor(pos_mel))
    j_out = types.SimpleNamespace(sq_vae_loss=None, **{
        k: jnp.asarray(v) for k, v in arrays.items()})
    out = types.SimpleNamespace(sq_vae_loss=None, **{
        k: torch.as_tensor(v) for k, v in arrays.items()})
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    tt = {k: torch.as_tensor(v) for k, v in targets.items()}
    _, ref = jax_losses.fastspeech2_loss(
        j_out, jt["mel"], jt["d"], jt["f0"], jt["energy"], src_mask=j_src,
        mel_mask=j_mel, **options)
    _, ours = losses.fastspeech2_loss(
        out, tt["mel"], tt["d"], tt["f0"], tt["energy"], src_mask=src,
        mel_mask=mel_mask, **options)
    assert sorted(ours) == sorted(ref)
    for key in ref:                 # fp32 means summed in another order
        assert ours[key].dtype == torch.float32
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5)


@pytest.mark.parametrize("option", [{"use_ssim": True},
                                    {"output_type": "softmax"},
                                    {"use_sq_vae": True}])
def test_losses_of_later_slices_raise(option):
    arrays, targets, pos_text, pos_mel = _outputs(1)
    if option == {"use_sq_vae": True}:
        # the SQ-VAE loss is ported: the AR-ELBO MSE on mel_pre and the
        # model's SQ-VAE loss added, as in the JAX package
        sq = dict(sq_vae_loss=np.float32(3.25),
                  sq_vae_perplexity=np.float32(17.5), **arrays)
        _, ref = jax_losses.fastspeech2_loss(
            types.SimpleNamespace(**{k: jnp.asarray(v)
                                     for k, v in sq.items()}),
            *(jnp.asarray(targets[k]) for k in ("mel", "d", "f0",
                                                 "energy")), **option)
        _, ours = losses.fastspeech2_loss(
            types.SimpleNamespace(**{k: torch.as_tensor(v)
                                     for k, v in sq.items()}),
            *(torch.as_tensor(targets[k]) for k in ("mel", "d", "f0",
                                                     "energy")), **option)
        assert sorted(ours) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                       rtol=1e-5, err_msg=key)
        return
    if option == {"use_ssim": True}:
        # SSIM is ported: -SSIM(mel_post, mel) is added, as in the JAX
        # package (tests/test_torch_port_conditioning.py holds ssim itself)
        _, ref = jax_losses.fastspeech2_loss(
            types.SimpleNamespace(sq_vae_loss=None, **{
                k: jnp.asarray(v) for k, v in arrays.items()}),
            *(jnp.asarray(targets[k]) for k in ("mel", "d", "f0",
                                                 "energy")), **option)
        _, ours = losses.fastspeech2_loss(
            types.SimpleNamespace(sq_vae_loss=None, **{
                k: torch.as_tensor(v) for k, v in arrays.items()}),
            *(torch.as_tensor(targets[k]) for k in ("mel", "d", "f0",
                                                     "energy")), **option)
        assert sorted(ours) == sorted(ref) and "loss_ssim" in ours
        for key in ref:
            np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                       rtol=1e-5, err_msg=key)
        return
    # the discrete mode is ported (tests/test_torch_port_discrete.py): the
    # cross-entropy of the (B, T, 2) codes, 320 on padding, as in JAX
    codes = np.random.RandomState(2).randint(
        0, 8, targets["mel"].shape[:2] + (2,)).astype(np.int32)
    codes[1, 13:] = 320
    _, ref = jax_losses.fastspeech2_loss(
        types.SimpleNamespace(sq_vae_loss=None, **{
            k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(codes), jnp.asarray(targets["d"]), None, None, **option)
    _, ours = losses.fastspeech2_loss(
        types.SimpleNamespace(sq_vae_loss=None, **{
            k: torch.as_tensor(v) for k, v in arrays.items()}),
        torch.as_tensor(codes), torch.as_tensor(targets["d"]), None, None,
        **option)
    assert sorted(ours) == sorted(ref) and "accuracy_1" in ours
    for key in ref:
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)


# ---- schedule and optimizer -------------------------------------------------

OPT_SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 3)}


def _opt_pair(name, clip=1.0, accum_grad=1, d_model=16, warmup_step=4):
    rs = np.random.RandomState(0)
    params = {k: (0.1 * rs.randn(*s)).astype(np.float32)
              for k, s in OPT_SHAPES.items()}
    tx = jax_schedule.build_optimizer(name, d_model, 1.0, warmup_step, 1e-3,
                                      clip, accum_grad)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = schedule.build_optimizer(tparams.values(), name, d_model, 1.0,
                                   warmup_step, 1e-3, clip, accum_grad)
    return params, tx, tparams, opt


def _grads(step):
    rs = np.random.RandomState(10 + step)
    scale = 0.02 if step == 1 else 2.0    # step 1 stays under the clip
    return {k: (scale * rs.randn(*s)).astype(np.float32)
            for k, s in OPT_SHAPES.items()}


def _opt_steps(params, tx, tparams, opt, n):
    """Yield (jax params, port params, port norm, jax norm) per update."""
    state = tx.init(params)
    for i in range(n):
        g = _grads(i)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for k, p in tparams.items():     # as a backward adds to .grad
            grad = torch.tensor(g[k])
            p.grad = grad if p.grad is None else p.grad + grad
        norm = opt.step()
        yield params, tparams, float(norm), float(optax.global_norm(g))


def test_noam_lr_of_the_first_three_updates_matches_optax():
    params, tx, tparams, opt = _opt_pair("Noam")
    jax_sched = jax_schedule.noam_schedule(16, 1.0, 4)
    lrs = []
    for _ in _opt_steps(params, tx, tparams, opt, 3):
        lrs.append(opt.inner.param_groups[0]["lr"])
    # optax reads the schedule at its count before incrementing it
    np.testing.assert_allclose(lrs, [float(jax_sched(i)) for i in range(3)],
                               rtol=1e-6)
    assert lrs[1] > lrs[0]


@pytest.mark.parametrize("name", ["Noam", "adam", "adamw"])
def test_three_updates_with_clip_match_build_optimizer(name):
    params, tx, tparams, opt = _opt_pair(name)
    for ref, ours, norm, ref_norm in _opt_steps(params, tx, tparams, opt, 3):
        np.testing.assert_allclose(norm, ref_norm, rtol=1e-6)
        for k in OPT_SHAPES:
            np.testing.assert_allclose(ours[k].detach().numpy(), ref[k],
                                       rtol=1e-6, atol=1e-6)


def test_accumulation_matches_multisteps():
    params, tx, tparams, opt = _opt_pair("Noam", accum_grad=2)
    before = {k: v.detach().clone() for k, v in tparams.items()}
    for i, (ref, ours, _, _) in enumerate(
            _opt_steps(params, tx, tparams, opt, 4)):
        for k in OPT_SHAPES:
            np.testing.assert_allclose(ours[k].detach().numpy(), ref[k],
                                       rtol=1e-6, atol=1e-6)
            if i % 2 == 0:        # the parameters do not move in between
                assert torch.equal(ours[k].detach(), before[k])
        before = {k: v.detach().clone() for k, v in tparams.items()}
        assert opt.count == (i + 1) // 2   # the inner count, the lr's step


def test_radam_comes_later():
    # RAdam is ported (tests/test_torch_port_parallel.py holds it step for
    # step against reference_radam): build_optimizer's clip then the
    # reference's RAdam match the JAX chain's, degenerate steps included
    params, tx, tparams, opt = _opt_pair("RAdam")
    assert isinstance(opt.inner, schedule.ReferenceRAdam)
    for ref, ours, norm, ref_norm in _opt_steps(params, tx, tparams, opt, 7):
        np.testing.assert_allclose(norm, ref_norm, rtol=1e-6)
        for k in OPT_SHAPES:
            np.testing.assert_allclose(ours[k].detach().numpy(), ref[k],
                                       rtol=1e-6, atol=1e-7)


def test_reference_init_statistics_and_zeros():
    hp = HParams(**SMALL)
    model = build_fastspeech2(hp, device="cpu")
    linear = model.encoder.layers[0].attn.q_linear.weight.detach().clone()
    schedule.apply_reference_init(model, torch.Generator().manual_seed(3))
    conv = model.decoder.layers[0].ff.f_1.weight        # (4d, d, k=1)
    std = float(np.sqrt(2.0 / conv[0].numel()))
    assert abs(conv.std().item() - std) < 0.05 * std
    assert abs(conv.mean().item()) < 0.05 * std
    assert torch.equal(model.encoder.layers[0].attn.q_linear.weight, linear)
    for name, p in model.named_parameters():
        if name.endswith("bias") and p.dim() == 1:
            assert not p.any(), name
    again = build_fastspeech2(hp, device="cpu")
    schedule.apply_reference_init(again, torch.Generator().manual_seed(3))
    assert torch.equal(again.decoder.layers[0].ff.f_1.weight, conv)


# ---- model pieces in train mode ---------------------------------------------

def test_batch_norm_train_statistics_match_flax_at_small_n():
    import flax.linen as fnn
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 3).astype(np.float32) * 2 + 1     # n = B*T = 8
    scale = (1 + 0.1 * rs.randn(3)).astype(np.float32)
    bias = (0.1 * rs.randn(3)).astype(np.float32)
    mean0 = (0.1 * rs.randn(3)).astype(np.float32)
    var0 = (1 + 0.1 * rs.rand(3)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, mutated = fnn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = batch_norm(3).train()
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean0),
                        "running_var": torch.tensor(var0),
                        "num_batches_tracked": torch.tensor(0)})
    out = bn(torch.tensor(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    # torch's own BatchNorm moves towards the unbiased variance: at n = 8
    # that is 8/7 of the biased one, which flax uses
    torch_bn = torch.nn.BatchNorm1d(3, momentum=0.01)
    torch_bn.load_state_dict(bn.state_dict())
    torch_bn.running_var.copy_(torch.tensor(var0))
    torch_bn.train()(torch.tensor(x).transpose(1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(), stats["var"],
                           rtol=1e-5)


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_scheduled_sampling_matches_jax(p):
    _, jmodel, variables, model = build_pair(p_scheduled_sampling=p)
    rs = np.random.RandomState(5)
    text = rs.randint(1, 40, (2, 8)).astype(np.int32)
    pos = np.tile(np.arange(1, 9, dtype=np.int32), (2, 1))
    t = 40
    d = rs.randint(2, 5, text.shape).astype(np.int32)
    f0 = rs.uniform(60, 800, (2, t)).astype(np.float32)
    energy = rs.uniform(0, 300, (2, t)).astype(np.float32)
    j_src, _ = jax_create_masks(jnp.asarray(pos), None)
    ref, _ = jmodel.apply(variables, jnp.asarray(text), j_src, t,
                          jnp.asarray(d), jnp.asarray(f0),
                          jnp.asarray(energy), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
    src, _ = create_masks(torch.as_tensor(pos), None)
    with torch.no_grad():
        ours = model.train()(torch.as_tensor(text), src, t,
                             torch.as_tensor(d), torch.as_tensor(f0),
                             torch.as_tensor(energy),
                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(to_np(ours.variance_adaptor_output),
                               to_np(ref.variance_adaptor_output), **TOL)
    teacher = model.variance_adaptor.pitch_embedding(torch.bucketize(
        torch.as_tensor(f0), model.variance_adaptor.pitch_bins))
    uses_target = torch.allclose(
        ours.variance_adaptor_output - ours.text_dur_predicted
        - model.variance_adaptor.energy_embedding(torch.bucketize(
            torch.as_tensor(energy), model.variance_adaptor.energy_bins)),
        teacher, atol=1e-5)
    assert uses_target == (p == 0.0)


# ---- one full train step ----------------------------------------------------

def _train_batch(seed=0, b=2, l=12, t=256, mel_dim=16, frames=(10, 22)):
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
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                alignment=dur, f0=f0, energy=energy)


def _jax_grads(jmodel, variables, batch):
    """jax.grad of the loss of ``make_fastspeech2_train_step``."""
    t = batch["mel"].shape[1]
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    src_mask, mel_mask = jax_create_masks(a["pos_text"], a["pos_mel"])

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            a["text"], src_mask, t, a["alignment"], a["f0"], a["energy"],
            mel_mask=mel_mask, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_losses.fastspeech2_loss(
            out, a["mel"], a["alignment"], a["f0"], a["energy"],
            src_mask=src_mask, mel_mask=mel_mask)[0]
    return jax.grad(loss)(variables["params"])


def test_train_step_matches_jax(monkeypatch):
    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    warmup = 10
    hp, jmodel, variables, model = build_pair(warmup_step=warmup)
    jhp = JaxHParams(**dict(SMALL, warmup_step=warmup))
    batch = _train_batch()
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
    state, logs = make_fastspeech2_train_step(hp, device="cpu")(state,
                                                                  batch)
    assert state.step == 1
    assert len(calls) == SMALL["n_layer_decoder"]   # the decoder's kernel
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-4, err_msg=key)
    # the optimizer clips the .grad in place: compare the clipped values
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
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


def test_entry_points_default_to_the_card():
    for fn in (init_fastspeech2_state, make_fastspeech2_train_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_fastspeech2_state(HParams(**SMALL))


@pytest.mark.parametrize("option,match", [
    ({"remat": True}, "remaining tools"),
    ({"model": "Transformer", "gst": True}, "AR")])
def test_train_options_of_later_slices_raise(option, match):
    hp = HParams(**dict(SMALL, **option))
    make = (make_transformer_train_step if hp.model == "Transformer"
            else make_fastspeech2_train_step)
    if hp.gst:
        # GST training is ported (tests/test_torch_port_gst.py): the step
        # builds and its model holds the style embedding
        assert callable(make(hp, device="cpu"))
        state = init_transformer_state(hp, device="cpu")
        assert state.model.style_embedding is not None
        return
    # remat is ported (tests/test_torch_port_parallel.py holds it against
    # the plain step with dropout on): the step recomputes the forward in
    # the backward and gives the plain step's loss and weights
    batch = _train_batch()
    plain = build_pair(warmup_step=10)[3]
    remat = copy.deepcopy(plain)
    logs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # small steps: one intra-op thread
    try:
        for name, model in (("plain", plain), ("remat", remat)):
            opt = schedule.build_optimizer(model.parameters(), "Noam", 32,
                                           1.0, 10)
            state = TrainState(model, opt, torch.Generator().manual_seed(0))
            _, logs[name] = make_fastspeech2_train_step(
                hp if name == "remat" else HParams(**SMALL), device="cpu")(
                    state, batch)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(float(logs["remat"]["loss_total"]),
                               float(logs["plain"]["loss_total"]), rtol=1e-6)
    for (name, a), b in zip(plain.state_dict().items(),
                            remat.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_fix_mask_train_step_loss_matches_jax():
    # the band-diagonal src_mask reaches the encoder, which keeps it on the
    # masked path, as in the JAX package
    extra = dict(fix_mask=5, warmup_step=10)
    hp, jmodel, variables, model = build_pair(**extra)
    jhp = JaxHParams(**dict(SMALL, **extra))
    batch = _train_batch(t=64, frames=(1, 5))
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    _, jlogs = jax_train_step(jmodel, jhp, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    def port_step(hp, model):
        opt = schedule.build_optimizer(
            model.parameters(), hp.optimizer, hp.d_model_decoder,
            hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
            hp.accum_grad)
        state = TrainState(model, opt, torch.Generator().manual_seed(0))
        return make_fastspeech2_train_step(hp, device="cpu")(state,
                                                             batch)[1]

    logs = port_step(hp, model)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-4, err_msg=key)
    unbanded = port_step(*build_pair(warmup_step=10)[::3])
    assert float(unbanded["loss_total"]) != float(logs["loss_total"])


# ---- data and checkpoints ---------------------------------------------------

def _corpus(tmp_path, n=6, mel_dim=16, frames_per=3, normalise=False):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 14)
        t_mel = t_text * frames_per
        base = tmp_path / f"utt{i}.npy"
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        np.save(tmp_path / f"utt{i}_alignment.npy",
                np.full((t_text,), frames_per, np.int32))
        np.save(tmp_path / f"utt{i}_f0.npy",
                (rs.rand(t_mel) * 300 + 60).astype(np.float32))
        np.save(tmp_path / f"utt{i}_energy.npy",
                (rs.rand(t_mel) * 100).astype(np.float32))
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


def test_dataset_and_collate_match_jax(tmp_path):
    script, extra = _corpus(tmp_path, normalise=True)
    cfg = dict(mel_dim=16, text_buckets=(8, 16), length_buckets=(16, 32),
               **extra)
    ours_ds = TTSDataset(script, HParams(**cfg))
    ref_ds = JaxTTSDataset(script, JaxHParams(**cfg))
    samples = [ours_ds[i] for i in range(3)]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        for key in ("text", "mel", "alignment", "f0", "energy"):
            np.testing.assert_allclose(s[key], r[key], rtol=1e-6)
        assert s["mel_length"] == r["mel_length"]
    # a duration total past the mel bucket is cut at its edge
    samples[0]["alignment"] = samples[0]["alignment"] * 4
    ours = batching.collate(samples, HParams(**cfg), pad_batch=True)
    ref = jax_batching.collate(samples, JaxHParams(**cfg))
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    assert ours["text"].shape[0] == 4 and ours["alignment"].sum(1).max() \
        == ours["mel"].shape[1]
    np.testing.assert_array_equal(ours_ds.mel_lengths(),
                                  ref_ds.mel_lengths())


@pytest.mark.parametrize("kind", ["lengths_sorted", "lengths_in_order",
                                  "num"])
def test_samplers_match_jax(kind):
    lengths = np.random.RandomState(3).randint(20, 400, 57)
    if kind == "num":
        make = lambda mod: mod.NumBatchSampler(57, 8, seed=5)  # noqa: E731
    else:
        make = lambda mod: mod.LengthsBatchSampler(  # noqa: E731
            lengths, 1200, seed=5, sort_by_length=kind == "lengths_sorted")
    ours, ref = make(sampler), make(jax_sampler)
    for _ in range(2):                      # two epochs, reshuffled
        assert [list(b) for b in ours] == [list(b) for b in ref]


def test_should_save_matches_jax():
    for max_epoch, per in ((200, 50), (30, 7), (5, 1)):
        for epoch in range(1, max_epoch + 1):
            assert checkpoint.should_save(epoch, max_epoch, per) == \
                jax_checkpoint.should_save(epoch, max_epoch, per)


def test_train_checkpoint_round_trip(tmp_path):
    hp = HParams(**dict(SMALL, optimizer="adam"))
    state = init_fastspeech2_state(hp, device="cpu")
    step = make_fastspeech2_train_step(hp, device="cpu")
    batch = _train_batch(t=64, frames=(1, 5))
    state, _ = step(state, batch)
    path = checkpoint.save_train_checkpoint(str(tmp_path), state, 3, hp)
    assert sorted(os.listdir(path)) == ["hparams.py", "model.pt",
                                        "train_state.pt"]
    other = init_fastspeech2_state(HParams(**dict(SMALL, optimizer="adam",
                                                  seed=9)), device="cpu")
    other, epoch = checkpoint.restore_train_checkpoint(str(tmp_path), other)
    assert epoch == 3 and other.step == 1
    assert checkpoint.list_epochs(str(tmp_path)) == [3]
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    _, logs_a = step(state, batch)
    _, logs_b = step(other, batch)
    assert float(logs_a["loss_total"]) == float(logs_b["loss_total"])


# ---- the CLIs ---------------------------------------------------------------

def _write_hp(tmp_path, script, **extra):
    cfg = dict(dict(SMALL, batch_size=2, max_epoch=2, save_per_epoch=1,
                    warmup_step=10, train_script=script,
                    save_dir=str(tmp_path / "ckpt"), text_buckets=(8, 16),
                    length_buckets=(32, 64)), **extra)
    path = tmp_path / "hparams.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path), cfg["save_dir"]


def test_train_cli_then_synthesis_cli_on_its_checkpoint(tmp_path, capsys):
    script, _ = _corpus(tmp_path)
    hp_path, save_dir = _write_hp(tmp_path, script)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "2", "--set", "dropout=0.1"])
    printed = capsys.readouterr().out
    assert "epoch 1 step 1 " in printed and "epoch 1 step 2 " in printed
    assert "grad_norm=" in printed and "loss_total=" in printed
    load_dir = os.path.join(save_dir, "epoch_1")
    assert sorted(os.listdir(load_dir)) == ["hparams.py", "model.pt",
                                            "train_state.pt"]
    assert "dropout = 0.1" in open(os.path.join(load_dir,
                                                "hparams.py")).read()
    out_dir = tmp_path / "gen"
    synth_cli.main(["--load_name", load_dir, "--test_script", script,
                    "--save", str(out_dir), "--max_frames", "64",
                    "--device", "cpu"])
    for idx in range(6):
        mel = np.load(out_dir / f"{idx}.npy")
        assert mel.shape[1] == 16 and np.isfinite(mel).all()
    # resume: the step count carries on from the checkpoint
    hp_path, _ = _write_hp(tmp_path, script, loaded_epoch=1)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "3"])
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "(step 2)" in printed
    assert "epoch 2 step 3 " in printed


def test_train_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script, _ = _corpus(tmp_path)
    hp_path, _ = _write_hp(tmp_path, script)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--hp_file", hp_path, "--max_steps", "1"])


@pytest.mark.parametrize("hp_extra,flags,match", [
    ({"model": "Transformer", "gst": True}, [], "AR"),
    ({"model": "SQFastSpeech2"}, [], "other model families"),
    ({"architecture": "mel-mel"}, [], "post-processing"),
    ({"architecture": "text-mel-mel"}, [], "post-processing"),
    ({}, ["--multihost"], "parallelism")])
def test_train_cli_paths_of_later_slices_raise(tmp_path, hp_extra, flags,
                                               match):
    script, _ = _corpus(tmp_path)
    hp_path, save_dir = _write_hp(tmp_path, script, **hp_extra)
    args = ["--hp_file", hp_path, "--device", "cpu", *flags]
    if flags == ["--multihost"]:
        # --multihost is ported (tests/test_torch_port_parallel.py runs it
        # at two ranks): one gloo rank steps through DDP and saves
        port = _free_port()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)        # a small model: one thread
        try:
            train_cli.main([*args, "--coordinator", f"127.0.0.1:{port}",
                            "--num_processes", "1", "--process_id", "0",
                            "--max_steps", "1"])
        finally:
            torch.set_num_threads(threads)
        state = torch.load(os.path.join(save_dir, "epoch_1", "model.pt"))
        assert not any(k.startswith("module.") for k in state)
        return
    if hp_extra.get("gst") or hp_extra.get("model") == "SQFastSpeech2":
        # the GST and SQ-VAE trainers are ported (tests/test_torch_port_gst
        # .py, tests/test_torch_port_sq.py): one step and its checkpoint
        train_cli.main([*args, "--max_steps", "1"])
        state = torch.load(os.path.join(save_dir, "epoch_1", "model.pt"))
        assert any(k.startswith(("style_embedding.",
                                 "variance_adaptor.codebook."))
                   for k in state)
        return
    # the mel-to-mel trainers are ported (tests/test_torch_port_post.py,
    # tests/test_torch_port_post_cli.py): one step and its checkpoint
    extra = dict(hp_extra)
    if hp_extra["architecture"] == "mel-mel":
        teacher = str(tmp_path / "teacher")
        checkpoint.save_checkpoint(
            build_fastspeech2(HParams(**SMALL), device="cpu"), teacher)
        extra.update(version=2, phone_embed=True, pretrain_model=teacher,
                     n_layer_post_model=1)
    hp_path, save_dir = _write_hp(tmp_path, script, **extra)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "1"])
    state = torch.load(os.path.join(save_dir, "epoch_1", "model.pt"))
    if hp_extra["architecture"] == "mel-mel":
        assert "linear2.weight" in state and "out.weight" in state
    else:
        assert any(k.startswith("post_model.") for k in state)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_train_cli_starts_from_pretrain_model(tmp_path, monkeypatch):
    # the model that takes the first step holds the pretrained checkpoint's
    # weights and BatchNorm statistics, not a fresh init's
    script, _ = _corpus(tmp_path)
    hp_path, save_dir = _write_hp(tmp_path, script, max_epoch=1)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "2"])
    pretrained = os.path.join(save_dir, "epoch_1")
    saved = torch.load(os.path.join(pretrained, checkpoint.CHECKPOINT_NAME),
                       weights_only=True)
    fresh = init_fastspeech2_state(HParams(**SMALL), device="cpu")
    assert any(not torch.equal(v, fresh.model.state_dict()[k])
               for k, v in saved.items() if "running" in k)

    first = []
    real = trainer_module.make_fastspeech2_train_step

    def recording_step(hp, device):
        step = real(hp, device=device)

        def step_fn(state, batch):
            if not first:
                first.append({k: v.clone()
                              for k, v in state.model.state_dict().items()})
            return step(state, batch)
        return step_fn

    monkeypatch.setattr(trainer_module, "make_fastspeech2_train_step",
                        recording_step)
    hp_path, _ = _write_hp(tmp_path, script, max_epoch=1,
                           pretrain_model=pretrained,
                           save_dir=str(tmp_path / "finetune"))
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "1"])
    assert sorted(first[0]) == sorted(saved)
    for key, value in saved.items():
        assert torch.equal(first[0][key], value), key
