"""The mel-to-mel post-processing line of the PyTorch port against the JAX
package on the CPU: the EMA VQ, the PostLowEnergy students, the encoder
taps, the semantic mask, the integrate model, the two losses, the three
trainers (3 steps each), the NaN guard, the eval step and the reference
checkpoint import.

Small models (d 32, 1 + 1 layers, 2 heads, mel 8), fp32, dropout 0,
inputs from numpy seeds; the JAX weights are random (biases, norm scales
and BatchNorm statistics non-trivial, tests/torch_port_pair.py) and carried
into the port by compat/from_jax. Forward outputs agree within 1e-5 unless
a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.models import fastspeech2 as jax_fs2_module
from transformer_tts_tpu.models.fastspeech2 import (
    semantic_mask as jax_semantic_mask)
from transformer_tts_tpu.models.postnets import Quantize as JaxQuantize
from transformer_tts_tpu.ops.masks import create_masks as jax_create_masks
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import post_trainers as jax_post
from transformer_tts_tpu.train.schedule import (
    build_optimizer as jax_build_optimizer)
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState, build_fastspeech2 as jax_build_fastspeech2,
    make_fastspeech2_eval_step as jax_eval_step)
from transformer_tts_tpu_torch.compat.from_jax import (
    post_state_dict_from_flax, state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models import fastspeech2 as fs2_module
from transformer_tts_tpu_torch.models.fastspeech2 import (
    build_fastspeech2, build_post_model, semantic_mask)
from transformer_tts_tpu_torch.models.postnets import Quantize
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops.masks import create_masks
from transformer_tts_tpu_torch.train import losses, post_trainers
from transformer_tts_tpu_torch.train.schedule import (
    build_optimizer, noam_schedule)
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_fastspeech2_eval_step)

from torch_port_pair import _random_params, build_pair, to_np

BASE = dict(vocab_size=20, mel_dim=8, mel_dim_post=8, d_model_encoder=32,
            d_model_decoder=32, n_layer_encoder=1, n_layer_decoder=1,
            n_head_encoder=2, n_head_decoder=2, n_layer_post_model=1,
            amp=False, dropout=0.0, dropout_postnet=0.0,
            dropout_variance_adaptor=0.0, warmup_step=10,
            reference_init=False)
FWD_TOL = 1e-5
B, L, T = 2, 8, 24
SEMANTIC_KEY = 123          # the semantic mask's fixed draw in both
# Adam moves an element by about lr or less per step when 1 - b1 <
# sqrt(1 - b2) (Kingma and Ba, 2.1; here 0.1 < 0.14): 1.5 x the steps'
# summed lr leaves room for the bias corrections
ADAM_STEP_BOUND = 1.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(**kw):
    return dict(BASE, **kw)


def vq_stats_of(shapes, rs):
    """Random EMA VQ buffers: a code table, positive cluster sizes and a
    matching running sum."""
    def leaf(path, x):
        name = path[-1].key
        if name == "cluster_size":
            return rs.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return rs.randn(*x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def student_inputs(hp, b=B, t=T, seed=0):
    rs = np.random.RandomState(seed)
    mel = rs.randn(b, t, hp.mel_dim).astype(np.float32)
    phone = rs.randn(b, t, hp.d_model_encoder).astype(np.float32)
    lens = np.array([t, t - 5])[:b]
    mask = (np.arange(t)[None] < lens[:, None])[:, None, :]
    spk = None
    if hp.spk_emb_postprocess_type == "speaker_id":
        spk = rs.randint(0, hp.num_speakers, (b,)).astype(np.int32)
    elif hp.spk_emb_postprocess_type == "x_vector":
        spk = rs.randn(b, hp.spk_emb_dim_postprocess).astype(np.float32)
    return mel, phone, mask, spk


def student_pair(seed=0, **kw):
    """(hp, jax student, its variables, port student) on the same
    weights and VQ buffers."""
    c = cfg(**kw)
    jhp, hp = JaxHParams(**c), HParams(**c)
    jmodel = jax_post.build_post_model(jhp)
    mel, phone, mask, spk = student_inputs(hp)
    args = (jnp.asarray(mel), jnp.asarray(mask))
    if hp.version not in (1, 5):
        args += (jnp.asarray(phone),)
        if spk is not None:
            args += (jnp.asarray(spk),)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, train=False))
    rs = np.random.RandomState(seed)
    variables = {"params": _random_params(shapes["params"], rs),
                 "batch_stats": _random_params(
                     shapes.get("batch_stats", {}), rs),
                 "vq_stats": vq_stats_of(shapes.get("vq_stats", {}), rs)}
    model = build_post_model(hp, device="cpu")
    model.load_state_dict(post_state_dict_from_flax(
        variables["params"], variables["batch_stats"],
        variables["vq_stats"], hp))
    return hp, jmodel, variables, model.eval()


def run_student(hp, jmodel, variables, model, *, train=False, t=T):
    mel, phone, mask, spk = student_inputs(hp, t=t)
    jargs = [jnp.asarray(mel), jnp.asarray(mask)]
    pargs = [torch.from_numpy(mel), torch.from_numpy(mask)]
    if hp.version not in (1, 5):
        jargs.append(jnp.asarray(phone))
        pargs.append(torch.from_numpy(phone))
        if spk is not None:
            jargs.append(jnp.asarray(spk))
            pargs.append(torch.from_numpy(spk).long()
                         if spk.dtype == np.int32 else torch.from_numpy(spk))
    jout = jmodel.apply(variables, *jargs, train=train,
                        rngs={"dropout": jax.random.PRNGKey(0)},
                        mutable=["batch_stats", "vq_stats"] if train
                        else False)
    model.train(train)
    with torch.no_grad():
        pout = model(*pargs)
    return jout, pout


# ---- the EMA VQ ------------------------------------------------------------

@pytest.mark.parametrize("mean", [False, True])
def test_quantize_forward_ema_and_straight_through(mean):
    rs = np.random.RandomState(3)
    d, n = 16, 20
    x = rs.randn(4, 12, d).astype(np.float32)
    stats = {"embed": rs.randn(d, n).astype(np.float32),
             "cluster_size": rs.uniform(0.5, 2, n).astype(np.float32),
             "embed_avg": rs.randn(d, n).astype(np.float32)}
    w = rs.randn(*((4, d) if mean else x.shape)).astype(np.float32)
    jq = JaxQuantize(d, n)

    def jloss(xx):
        (q, diff, ind), mutated = jq.apply(
            {"vq_stats": stats}, xx, mean=mean, train=True,
            mutable=["vq_stats"])
        return (q * w).sum() + diff, (q, diff, ind, mutated["vq_stats"])
    (jl, (jqv, jdiff, jind, jstats)), jgrad = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(x))

    q = Quantize(d, n)
    for k, v in stats.items():
        getattr(q, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    pq, pdiff, pind = q(xt, mean=mean)
    ((pq * torch.from_numpy(w)).sum() + pdiff).backward()
    np.testing.assert_array_equal(pind.numpy(), np.asarray(jind))
    np.testing.assert_allclose(pq.detach().numpy(), np.asarray(jqv),
                               atol=FWD_TOL)
    np.testing.assert_allclose(float(pdiff), float(jdiff), rtol=FWD_TOL)
    # straight through: d/dx = w + the commitment's 2 (x - q) / n
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=FWD_TOL)
    for k in stats:                          # the EMA update, train mode
        np.testing.assert_allclose(getattr(q, k).numpy(),
                                   np.asarray(jstats[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # eval mode moves nothing
    before = {k: getattr(q, k).clone() for k in stats}
    q.eval()
    q(xt.detach(), mean=mean)
    assert all(torch.equal(getattr(q, k), before[k]) for k in stats)
    assert all(getattr(q, k).dtype == torch.float32 for k in stats)


def test_quantize_under_autocast_is_fp32():
    # the port takes the distances, argmin and EMA in fp32 with autocast
    # off (the JAX module takes them from a bf16 input under amp)
    q = Quantize(16, 20).train()
    x = torch.randn(2, 5, 16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out, diff, _ = q(x.bfloat16())
    assert out.dtype == diff.dtype == torch.float32
    assert q.embed.dtype == torch.float32


# ---- the students ----------------------------------------------------------

STUDENTS = {
    "v1": dict(version=1),
    "v2-phone_embed": dict(version=2, phone_embed=True),
    "v2-concat-xvector": dict(version=2, concat=True,
                              spk_emb_postprocess_type="x_vector",
                              spk_emb_dim_postprocess=12),
    "v2-speaker_id": dict(version=2, phone_embed=True,
                          spk_emb_postprocess_type="speaker_id",
                          num_speakers=5),
    "v2-xvector": dict(version=7, spk_emb_postprocess_type="x_vector",
                       spk_emb_dim_postprocess=12),
    "v3-vq_code": dict(version=3, phone_embed=True, vq_code=True),
    "v2-post_conformer": dict(version=2, phone_embed=True,
                              post_conformer=True),
    "v2-taps": dict(version=2, n_layer_post_model=2,
                    intermediate_layers_out=(0, 1)),
    "v5-kernel-plain": dict(version=5, n_layer_post_model=2),
}


@pytest.mark.parametrize("case", sorted(STUDENTS))
def test_student_forward_matches_jax(case, monkeypatch):
    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    hp, jmodel, variables, model = student_pair(**STUDENTS[case])
    t = 300 if case == "v5-kernel-plain" else T
    jout, pout = run_student(hp, jmodel, variables, model, t=t)
    if hp.version in (1, 5):
        np.testing.assert_allclose(to_np(pout), np.asarray(jout),
                                   atol=FWD_TOL)
        # T >= 256: the port's attention takes its kernel's plain version
        assert len(calls) == (hp.n_layer_post_model if t >= 256 else 0)
        return
    (jo, jtaps, jdiff), (po, ptaps, pdiff) = jout, pout
    np.testing.assert_allclose(to_np(po), np.asarray(jo), atol=FWD_TOL)
    if hp.intermediate_layers_out:
        assert len(ptaps) == len(jtaps) == 2
        for a, b in zip(ptaps, jtaps):
            assert a.shape[-1] == 80
            np.testing.assert_allclose(to_np(a), np.asarray(b),
                                       atol=FWD_TOL)
    else:
        assert ptaps is None and jtaps is None
    if hp.vq_code:
        np.testing.assert_allclose(float(pdiff), float(jdiff), rtol=1e-5)
    else:
        assert pdiff is None and jdiff is None


def test_student_train_forward_moves_statistics_as_jax():
    # the conformer student's BatchNorm and the VQ move in train mode
    hp, jmodel, variables, model = student_pair(
        version=3, phone_embed=True, vq_code=True, post_conformer=True)
    (jout, mutated), pout = run_student(hp, jmodel, variables, model,
                                        train=True)
    np.testing.assert_allclose(to_np(pout[0]), np.asarray(jout[0]),
                               atol=FWD_TOL)
    want = post_state_dict_from_flax(variables["params"],
                                     mutated["batch_stats"],
                                     mutated["vq_stats"], hp)
    for name, value in model.state_dict().items():
        if "running" in name or "quantize_lmfb" in name:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_concat_with_speaker_ids_raises():
    with pytest.raises(ValueError, match="concat"):
        build_post_model(HParams(**cfg(version=2, concat=True,
                                       spk_emb_postprocess_type="speaker_id",
                                       num_speakers=3)), device="cpu")


def test_encoder_taps_exclude_ctc():
    from transformer_tts_tpu_torch.models.encoder import Encoder
    with pytest.raises(ValueError, match="exclusive"):
        Encoder(8, 32, 2, 2, 5, ctc_out=True, intermediate_layers_out=(0,))


# ---- the semantic mask -----------------------------------------------------

@pytest.mark.parametrize("with_phone", [False, True])
def test_semantic_mask_bit_for_bit(with_phone):
    rs = np.random.RandomState(5)
    b, n_phones, t = 3, 10, 60
    mel = rs.randn(b, t, 8).astype(np.float32)
    phone = rs.randn(b, t, 16).astype(np.float32)
    d = rs.randint(0, 7, (b, n_phones)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    jm, jp, jf = jax_semantic_mask(jnp.asarray(mel),
                                   jnp.asarray(phone) if with_phone
                                   else None, jnp.asarray(d), 0.4, key)
    uniform = torch.from_numpy(np.asarray(
        jax.random.uniform(key, (b, n_phones))))
    pm, pp, pf = semantic_mask(torch.from_numpy(mel),
                               torch.from_numpy(phone) if with_phone
                               else None, torch.from_numpy(d), 0.4,
                               uniform=uniform)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pf.any() and not pf.all()
    if with_phone:
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    else:
        assert pp is None and jp is None


def test_semantic_mask_draws_from_the_generator():
    mel = torch.zeros(2, 30, 4)
    d = torch.full((2, 10), 3)
    a = semantic_mask(mel, None, d, 0.5,
                      generator=torch.Generator().manual_seed(1))[2]
    b = semantic_mask(mel, None, d, 0.5,
                      generator=torch.Generator().manual_seed(1))[2]
    c = semantic_mask(mel, None, d, 0.5,
                      generator=torch.Generator().manual_seed(2))[2]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture
def fixed_semantic_draws(monkeypatch):
    """Both packages' semantic masks draw jax.random.uniform of one fixed
    key: the JAX function's key replaced, the port's draws patched."""
    key = jax.random.PRNGKey(SEMANTIC_KEY)

    def jax_fixed(mel, phone, d, p, rng, eps=1e-4):
        return jax_semantic_mask(mel, phone, d, p, key, eps)

    def port_fixed(b, n, device, generator):
        return torch.from_numpy(np.asarray(
            jax.random.uniform(key, (b, n)))).to(device)
    monkeypatch.setattr(jax_fs2_module, "semantic_mask", jax_fixed)
    monkeypatch.setattr(jax_post, "semantic_mask", jax_fixed)
    monkeypatch.setattr(fs2_module, "mask_uniform", port_fixed)


# ---- the losses ------------------------------------------------------------

def test_time_weighted_l1_and_cosine_embedding_loss():
    rs = np.random.RandomState(7)
    a, b = (rs.randn(3, 20, 8).astype(np.float32) for _ in range(2))
    m = rs.rand(3, 20, 1) < 0.3
    want = jax_losses.time_weighted_l1(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(m), (0.7, 0.3), 8)
    got = losses.time_weighted_l1(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(m), (0.7, 0.3), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = jax_losses.cosine_embedding_loss(jnp.asarray(a), jnp.asarray(b))
    got = losses.cosine_embedding_loss(torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(losses.cosine_embedding_loss(torch.from_numpy(a),
                                              torch.from_numpy(a))) < 1e-6


# ---- the integrate model ---------------------------------------------------

def batch_of(hp, seed=0, b=B, l=L, t=T, frames=(T, T - 6)):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, hp.vocab_size, (b, l)).astype(np.int32)
    pos_text = np.tile(np.arange(1, l + 1, dtype=np.int32), (b, 1))
    dur = np.zeros((b, l), np.int32)
    for i, total in enumerate(frames[:b]):
        w = rs.rand(l) + 0.5
        d = np.floor(w / w.sum() * total).astype(np.int32)
        d[: total - d.sum()] += 1
        dur[i] = d
    pos_mel = np.zeros((b, t), np.int32)
    mel = np.full((b, t, hp.mel_dim), -5.0, np.float32)
    f0 = np.zeros((b, t), np.float32)
    energy = np.zeros((b, t), np.float32)
    for i, total in enumerate(frames[:b]):
        pos_mel[i, :total] = np.arange(1, total + 1)
        mel[i, :total] = rs.randn(total, hp.mel_dim)
        f0[i, :total] = rs.uniform(60, 800, total)
        energy[i, :total] = rs.uniform(0, 315, total)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                alignment=dur, f0=f0, energy=energy)


def integrate_pair(seed=0, **kw):
    """(hp, jax model, variables, port model) of the text-mel-mel
    FastSpeech 2 on the same weights."""
    c = cfg(architecture="text-mel-mel", postnet_pred=False,
            phone_embed=True, **kw)
    jhp, hp = JaxHParams(**c), HParams(**c)
    jmodel = jax_build_fastspeech2(jhp, enable_post_model=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.ones((B, L), jnp.int32), jnp.ones((B, 1, L), bool), T,
        jnp.full((B, L), 3, jnp.int32), jnp.zeros((B, T)),
        jnp.zeros((B, T)), train=False))
    rs = np.random.RandomState(seed)
    params = _random_params(shapes["params"], rs)
    va = params["variance_adaptor"]
    for name, bias in (("duration", np.log(4.0)), ("pitch", 200.0),
                       ("energy", 100.0)):
        va[f"{name}_predictor"]["linear_layer"]["bias"][:] = bias
    variables = {"params": params,
                 "batch_stats": _random_params(shapes.get("batch_stats", {}),
                                               rs),
                 "vq_stats": vq_stats_of(shapes.get("vq_stats", {}), rs)}
    model = build_fastspeech2(hp, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        params, variables["batch_stats"], hp, variables["vq_stats"]))
    return hp, jmodel, variables, model


INTEGRATE = {3: dict(), 8: dict(semantic_mask=True),
             9: dict(semantic_mask=True, semantic_mask_phone=True),
             10: dict(n_layer_post_model=2, intermediate_layers_out=(1,),
                      mel_dim=80, mel_dim_post=80)}


@pytest.mark.parametrize("version", sorted(INTEGRATE))
@pytest.mark.parametrize("train", [False, True])
def test_integrate_forward_matches_jax(version, train,
                                       fixed_semantic_draws):
    hp, jmodel, variables, model = integrate_pair(version=version,
                                                  **INTEGRATE[version])
    a = batch_of(hp)
    src_mask, mel_mask = jax_create_masks(jnp.asarray(a["pos_text"]),
                                          jnp.asarray(a["pos_mel"]))
    jout = jmodel.apply(
        variables, jnp.asarray(a["text"]), src_mask, T,
        jnp.asarray(a["alignment"]), jnp.asarray(a["f0"]),
        jnp.asarray(a["energy"]), mel_mask=mel_mask, train=train,
        rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats", "vq_stats"] if train else False)
    if train:
        jout = jout[0]
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    psrc, pmel = create_masks(t["pos_text"], t["pos_mel"])
    model.train(train)
    with torch.no_grad():
        pout = model(t["text"], psrc, T, t["alignment"], t["f0"],
                     t["energy"], pmel)
    np.testing.assert_allclose(to_np(pout.mel_pre), np.asarray(jout.mel_pre),
                               atol=FWD_TOL)
    jpost, ppost = jout.post_output, pout.post_output
    if version in (8, 9, 10):
        assert isinstance(ppost, tuple) and len(ppost) == 2
        for p_, j_ in zip(ppost, jpost):
            np.testing.assert_allclose(to_np(p_), np.asarray(j_),
                                       atol=FWD_TOL)
    else:
        np.testing.assert_allclose(to_np(ppost), np.asarray(jpost),
                                   atol=FWD_TOL)
    if train and hp.semantic_mask:
        np.testing.assert_array_equal(pout.mask_frames.numpy(),
                                      np.asarray(jout.mask_frames))
        assert pout.mask_frames.any()
    else:
        assert pout.mask_frames is None and jout.mask_frames is None


def test_version_10_without_taps_returns_the_bare_output():
    # the model returns the bare output, as JAX's; the step refuses it
    hp, _, _, model = integrate_pair(version=10, n_layer_post_model=1)
    a = {k: torch.from_numpy(v) for k, v in batch_of(hp).items()}
    src, mel_mask = create_masks(a["pos_text"], a["pos_mel"])
    with torch.no_grad():
        out = model.eval()(a["text"], src, T, a["alignment"])
    assert torch.is_tensor(out.post_output)
    with pytest.raises(ValueError, match="intermediate_layers_out"):
        post_trainers.make_integrate_train_step(hp, device="cpu")


@pytest.mark.parametrize("version", [8, 9, 10])
def test_versions_8_to_10_with_postnet_pred_raise(version):
    hp = HParams(**cfg(architecture="text-mel-mel", version=version,
                       postnet_pred=True, intermediate_layers_out=(0,)))
    with pytest.raises(ValueError, match="postnet_pred"):
        post_trainers.make_integrate_train_step(hp, device="cpu")


# ---- the trainers, 3 steps each --------------------------------------------

def jax_state(params, batch_stats, vq_stats, hp):
    tx = jax_build_optimizer(hp.optimizer, hp.d_model_decoder,
                             hp.warmup_factor, hp.warmup_step,
                             hp.learning_rate, hp.clip, hp.accum_grad)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), batch_stats=batch_stats,
                         vq_stats=vq_stats, tx=tx)


def port_state(model, hp):
    opt = build_optimizer(model.parameters(), hp.optimizer,
                          hp.d_model_decoder, hp.warmup_factor,
                          hp.warmup_step, hp.learning_rate, hp.clip,
                          hp.accum_grad)
    return TrainState(model, opt, torch.Generator().manual_seed(0))


def host(tree):
    return jax.tree.map(np.array, tree)


def adam_moments(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return host(adam.mu), host(adam.nu)


def compare_steps(hp, jstep, jst, pstep, pst, batches, convert):
    """Run both steps on ``batches`` and hold the port to JAX under the
    Adam-noise rule. Adam normalises each element's step, so an element
    whose gradient is rounding noise around 0 (key biases, biases before a
    BatchNorm, a ReLU input within rounding of 0) takes any step in [-lr,
    lr] in either package, and from the second step on the outputs and
    the other gradients carry that difference. So: the first step's logs
    within 1e-4, the later steps' within 1e-3; the weights whose first
    gradient is above 1e-7 within 1e-4 or 5 % of the steps' summed lr,
    the others moved within Adam's bound; BatchNorm and VQ statistics
    within 1e-5 or the summed lr (a noise bias before a BatchNorm shifts
    its mean by as much). Returns the last (jax state, port state,
    logs)."""
    old = {k: v.clone() for k, v in pst.model.state_dict().items()}
    lr_sum = sum(noam_schedule(hp.d_model_decoder, hp.warmup_factor,
                               hp.warmup_step)(i)
                 for i in range(len(batches)))
    for i, batch in enumerate(batches):
        jst, jlogs = jstep(jst, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jax.random.PRNGKey(i))
        pst, plogs = pstep(pst, batch)
        for key, value in jlogs.items():
            np.testing.assert_allclose(float(plogs[key]), float(value),
                                       rtol=1e-4 if i == 0 else 1e-3,
                                       atol=1e-6,
                                       err_msg=f"step {i}: {key}")
        if i == 0:
            settled = first_grads_settled(pst)
    want = convert(host(jst.params), host(jst.batch_stats),
                   host(jst.vq_stats))
    for name, value in pst.model.state_dict().items():
        ref = want[name].numpy()
        got = value.numpy()
        if name in settled:
            ok = settled[name]
            np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4,
                                       atol=0.05 * lr_sum, err_msg=name)
            moved = np.abs(got - old[name].numpy())[~ok]
            assert np.all(moved <= lr_sum * ADAM_STEP_BOUND), name
        elif value.is_floating_point():
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=max(1e-6, lr_sum), err_msg=name)
    return jst, pst, plogs


def first_grads_settled(pst):
    """{name: |grad| > 1e-7} of the port's first step (after clipping:
    the same elements)."""
    return {n: np.abs(p.grad.numpy()) > 1e-7
            for n, p in pst.model.named_parameters()}


MELMEL = {v: dict(version=v, phone_embed=v in (2, 3, 4, 6, 7))
          for v in range(1, 8)}
MELMEL[2].update(semantic_mask=True, semantic_mask_phone=True)
MELMEL[3].update(vq_code=True)
MELMEL[6].update(post_conformer=True)


def teacher_and_student(seed=0, **kw):
    overrides = dict(BASE, **kw)
    overrides.pop("mel_dim_post")
    hp_t, jteacher, tvars, teacher = build_pair(seed, **overrides)
    hp, jstudent, svars, student = student_pair(seed + 1, **kw)
    return jteacher, tvars, teacher, hp, jstudent, svars, student


@pytest.mark.parametrize("version", sorted(MELMEL))
def test_meltomel_steps_match_jax(version, fixed_semantic_draws):
    kw = MELMEL[version]
    jteacher, tvars, teacher, hp, jstudent, svars, student = \
        teacher_and_student(architecture="mel-mel", **kw)
    jhp = JaxHParams(**cfg(architecture="mel-mel", **kw))
    jstep = jax_post.make_meltomel_train_step(jteacher, tvars, jstudent,
                                              jhp, donate=False)
    jst = jax_state(svars["params"], svars["batch_stats"],
                    svars["vq_stats"], jhp)
    pst = port_state(student, hp)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    pstep = post_trainers.make_meltomel_train_step(teacher, hp,
                                                   device="cpu")
    batches = [batch_of(hp, seed=s) for s in range(3)]
    _, pst, logs = compare_steps(
        hp, jstep, jst, pstep, pst, batches,
        lambda p, b, v: post_state_dict_from_flax(p, b, v, hp))
    assert pst.step == 3 and not bool(logs["skipped_nan"])
    # the teacher is frozen: not a weight or a statistic moved
    assert all(torch.equal(v, teacher_before[k])
               for k, v in teacher.state_dict().items())


def pregen_batch(hp, seed):
    """A pregenerated-corpus batch: ``batch_of`` plus a teacher mel and
    phone features (the pad rows as the collate pads them)."""
    b = batch_of(hp, seed=seed)
    rs = np.random.RandomState(100 + seed)
    valid = (b["pos_mel"] > 0)[..., None]
    b["teacher_mel"] = np.where(valid, rs.randn(B, T, hp.mel_dim),
                                -5.0).astype(np.float32)
    b["teacher_phone"] = np.where(valid, rs.randn(B, T, hp.d_model_encoder),
                                  0.0).astype(np.float32)
    return b


@pytest.mark.parametrize("version", [1, 3, 4])
def test_pregen_steps_match_jax(version):
    kw = dict(version=version, phone_embed=version != 1,
              vq_code=version == 3)
    hp, jstudent, svars, student = student_pair(architecture="mel-mel",
                                                teacher_suffix="_gen", **kw)
    jhp = JaxHParams(**cfg(architecture="mel-mel", teacher_suffix="_gen",
                           **kw))
    jstep = jax_post.make_meltomel_pregen_train_step(jstudent, jhp,
                                                     donate=False)
    pst = port_state(student, hp)
    compare_steps(hp, jstep, jax_state(svars["params"], svars["batch_stats"],
                                   svars["vq_stats"], jhp),
                  post_trainers.make_meltomel_pregen_train_step(
                      hp, device="cpu"), pst,
                  [pregen_batch(hp, s) for s in range(3)],
                  lambda p, b, v: post_state_dict_from_flax(p, b, v, hp))


def test_pregen_without_phone_features_raises():
    hp = HParams(**cfg(architecture="mel-mel", teacher_suffix="_gen",
                       version=2))
    state = port_state(build_post_model(hp, device="cpu"), hp)
    batch = pregen_batch(hp, 0)
    del batch["teacher_phone"]
    with pytest.raises(ValueError, match="--save_phone"):
        post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")(
            state, batch)


INTEGRATE_STEPS = {
    3: dict(),
    8: dict(semantic_mask=True, time_weight=(0.7, 0.3)),
    9: dict(semantic_mask=True, semantic_mask_phone=True),
    10: dict(n_layer_post_model=2, intermediate_layers_out=(1,), mel_dim=80,
             mel_dim_post=80)}


@pytest.mark.parametrize("version", sorted(INTEGRATE_STEPS))
def test_integrate_steps_match_jax(version, fixed_semantic_draws):
    kw = dict(version=version, **INTEGRATE_STEPS[version])
    hp, jmodel, variables, model = integrate_pair(**kw)
    jhp = JaxHParams(**cfg(architecture="text-mel-mel", postnet_pred=False,
                           phone_embed=True, **kw))
    jstep = jax_post.make_integrate_train_step(jmodel, jhp, donate=False)
    pst = port_state(model, hp)
    _, _, logs = compare_steps(
        hp, jstep, jax_state(variables["params"], variables["batch_stats"],
                         variables["vq_stats"], jhp),
        post_trainers.make_integrate_train_step(hp, device="cpu"), pst,
        [batch_of(hp, seed=s) for s in range(3)],
        lambda p, b, v: state_dict_from_flax(p, b, hp, v))
    if version in (8, 9, 10):
        assert "replace_loss" in logs


def test_integrate_step_with_the_cosine_loss_matches_jax():
    # one step: the cosine loss's gradients on elements that exact
    # arithmetic leaves near 0 are rounding noise of either sign, which
    # Adam's normalised second step turns into opposite lr-sized moves
    kw = dict(version=3, use_cosine_emb_loss=True)
    hp, jmodel, variables, model = integrate_pair(**kw)
    jhp = JaxHParams(**cfg(architecture="text-mel-mel", postnet_pred=False,
                           phone_embed=True, **kw))
    _, _, logs = compare_steps(
        hp, jax_post.make_integrate_train_step(jmodel, jhp, donate=False),
        jax_state(variables["params"], variables["batch_stats"],
                  variables["vq_stats"], jhp),
        post_trainers.make_integrate_train_step(hp, device="cpu"),
        port_state(model, hp), [batch_of(hp)],
        lambda p, b, v: state_dict_from_flax(p, b, hp, v))
    assert float(logs["loss_cosine_emb"]) > 0


# ---- the NaN guard ---------------------------------------------------------

def assert_guarded_as_jax(hp, jst, pst, settled) -> bool:
    """The port's weights and Adam moments where the first gradient is not
    noise (``settled``) within 1e-4 of JAX's and finite, and the
    statistics (NaN included) within 1e-5; returns whether a statistic is
    NaN."""
    convert = lambda p, b, v: post_state_dict_from_flax(p, b, v, hp)  # noqa
    want = convert(host(jst.params), host(jst.batch_stats),
                   host(jst.vq_stats))
    mu, nu = adam_moments(jst.opt_state)
    bs, vq = host(jst.batch_stats), host(jst.vq_stats)
    want_mu, want_nu = convert(mu, bs, vq), convert(nu, bs, vq)
    saw_nan = False
    for name, value in pst.model.state_dict().items():
        got, ref = value.numpy(), want[name].numpy()
        if name in settled:
            ok = settled[name]
            np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            p = dict(pst.model.named_parameters())[name]
            st = pst.optimizer.inner.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy()[ok],
                                       want_mu[name].numpy()[ok],
                                       rtol=1e-4, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy()[ok],
                                       want_nu[name].numpy()[ok],
                                       rtol=1e-4, atol=1e-12, err_msg=name)
            assert np.isfinite(got).all(), name
        elif value.is_floating_point():
            # the statistics the non-finite forward moved stay moved
            saw_nan |= bool(np.isnan(got).any())
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       equal_nan=True, err_msg=name)
    return saw_nan


def test_nan_guard_takes_the_update_as_jax():
    # a conformer student with the VQ: a NaN planted in the second step's
    # teacher mel makes the forward, the loss, the BatchNorm and VQ
    # statistics non-finite; JAX zeroes the gradients and still steps
    kw = dict(version=3, phone_embed=True, vq_code=True,
              post_conformer=True)
    hp, jstudent, svars, student = student_pair(architecture="mel-mel",
                                                teacher_suffix="_gen", **kw)
    jhp = JaxHParams(**cfg(architecture="mel-mel", teacher_suffix="_gen",
                           **kw))
    jstep = jax_post.make_meltomel_pregen_train_step(jstudent, jhp,
                                                     donate=False)
    jst = jax_state(svars["params"], svars["batch_stats"],
                    svars["vq_stats"], jhp)
    pst = port_state(student, hp)
    pstep = post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")
    bad = pregen_batch(hp, 1)
    bad["teacher_mel"][0, 3, 2] = np.nan
    batches = [pregen_batch(hp, 0), bad]
    for i, batch in enumerate(batches):
        jst, jlogs = jstep(jst, {k: jnp.asarray(v)
                                 for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        pst, plogs = pstep(pst, batch)
        if i == 0:
            settled = first_grads_settled(pst)
    assert bool(jlogs["skipped_nan"]) and bool(plogs["skipped_nan"])
    assert float(plogs["grad_norm"]) == float(jlogs["grad_norm"]) == 0.0
    assert not np.isfinite(float(plogs["loss_total"]))
    assert pst.step == 2 and pst.optimizer.count == 2
    assert int(jst.step) == 2
    assert assert_guarded_as_jax(hp, jst, pst, settled)


def test_nan_guard_moves_parameters_by_the_moments():
    # with zeroed gradients the update is Adam's decayed moments: a port
    # that skipped optimizer.step() would leave the weights still
    hp = HParams(**cfg(architecture="mel-mel", teacher_suffix="_gen",
                       version=1))
    pst = port_state(build_post_model(hp, device="cpu"), hp)
    step = post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")
    pst, _ = step(pst, pregen_batch(hp, 0))
    before = {k: v.clone() for k, v in pst.model.state_dict().items()}
    bad = pregen_batch(hp, 1)
    bad["mel"][1, 2, 0] = np.inf
    pst, logs = step(pst, bad)
    assert bool(logs["skipped_nan"]) and pst.optimizer.count == 2
    assert any(not torch.equal(v, before[k])
               for k, v in pst.model.state_dict().items())
    assert all(bool(torch.isfinite(p).all())
               for p in pst.model.parameters())


def test_nan_guard_mid_accumulation_keeps_the_earlier_micro_steps():
    # accum_grad 2: a NaN in the second micro-step of the first
    # accumulation zeroes that micro-step's gradients only (JAX's
    # MultiSteps keeps the first's), one in the first micro-step of the
    # second zeroes that one; zeroing .grad, which holds the partial sum,
    # would take a zero update for the first accumulation
    kw = dict(version=1, accum_grad=2)
    hp, jstudent, svars, student = student_pair(architecture="mel-mel",
                                                teacher_suffix="_gen", **kw)
    jhp = JaxHParams(**cfg(architecture="mel-mel", teacher_suffix="_gen",
                           **kw))
    jstep = jax_post.make_meltomel_pregen_train_step(jstudent, jhp,
                                                     donate=False)
    jst = jax_state(svars["params"], svars["batch_stats"],
                    svars["vq_stats"], jhp)
    pst = port_state(student, hp)
    pstep = post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")
    batches = [pregen_batch(hp, s) for s in range(4)]
    for bad in batches[1:3]:
        bad["teacher_mel"][0, 3, 2] = np.nan
    skipped = []
    for i, batch in enumerate(batches):
        jst, jlogs = jstep(jst, {k: jnp.asarray(v)
                                 for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        pst, plogs = pstep(pst, batch)
        assert bool(plogs["skipped_nan"]) == bool(jlogs["skipped_nan"])
        skipped.append(bool(plogs["skipped_nan"]))
        if i == 0:
            settled = first_grads_settled(pst)
    assert skipped == [False, True, True, False]
    assert pst.optimizer.count == 2 and pst.optimizer.mini_step == 0
    assert pst.step == 4 and int(jst.step) == 4
    assert not assert_guarded_as_jax(hp, jst, pst, settled)


# ---- the eval step ---------------------------------------------------------

def test_eval_step_matches_jax():
    hp, jmodel, variables, model = build_pair(3, **{
        k: v for k, v in BASE.items() if k != "mel_dim_post"})
    batch = batch_of(hp)
    jst = jax_state(variables["params"], variables["batch_stats"], {},
                    JaxHParams(**cfg()))
    jout, jlogs = jax_eval_step(jmodel, JaxHParams(**cfg()))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    pout, plogs = make_fastspeech2_eval_step(hp, device="cpu")(
        TrainState(model, None, None), batch)
    np.testing.assert_allclose(to_np(pout.mel_post),
                               np.asarray(jout.mel_post), atol=FWD_TOL)
    np.testing.assert_allclose(to_np(pout.variance_adaptor_output),
                               np.asarray(jout.variance_adaptor_output),
                               atol=FWD_TOL)
    assert sorted(plogs) == sorted(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(float(plogs[key]), float(jlogs[key]),
                                   rtol=1e-5, err_msg=key)
    assert not model.training


# ---- the reference checkpoint import ---------------------------------------

@pytest.mark.parametrize("case", ["v1", "v3-vq_code", "v2-speaker_id"])
def test_reference_student_checkpoint_loads_as_jax(case, tmp_path):
    from transformer_tts_tpu.compat.torch_import import (
        convert_post_low_energy_state_dict)
    from transformer_tts_tpu_torch.compat.torch_import import (
        load_post_low_energy_checkpoint)
    hp, jmodel, _, model = student_pair(**STUDENTS[case])
    state = {f"module.{k}": v for k, v in model.state_dict().items()}
    path = str(tmp_path / "network.epoch1")
    torch.save(state, path)
    jhp = JaxHParams(**cfg(**STUDENTS[case]))
    params, bstats, vq = convert_post_low_energy_state_dict(
        {k: v.numpy() for k, v in state.items()}, jhp)
    loaded = load_post_low_energy_checkpoint(path, hp, device="cpu")
    jout, pout = run_student(hp, jmodel, {"params": params,
                                          "batch_stats": bstats,
                                          "vq_stats": vq}, loaded)
    if hp.version in (1, 5):
        np.testing.assert_allclose(to_np(pout), np.asarray(jout),
                                   atol=FWD_TOL)
    else:
        np.testing.assert_allclose(to_np(pout[0]), np.asarray(jout[0]),
                                   atol=FWD_TOL)


def test_reference_conformer_student_raises(tmp_path):
    from transformer_tts_tpu.compat.torch_import import (
        convert_post_low_energy_state_dict)
    from transformer_tts_tpu_torch.compat.torch_import import (
        load_post_low_energy_checkpoint)
    c = cfg(version=2, post_conformer=True)
    with pytest.raises(NotImplementedError):
        convert_post_low_energy_state_dict({}, JaxHParams(**c))
    with pytest.raises(NotImplementedError, match="post_conformer"):
        load_post_low_energy_checkpoint(str(tmp_path / "x"), HParams(**c),
                                        device="cpu")
