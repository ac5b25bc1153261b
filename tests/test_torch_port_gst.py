"""The port's GST Transformer-TTS (models/gst.py and ``gst`` in the AR
model, its training, synthesis with a reference mel and the CLIs) against
the JAX package, on the CPU in fp32.

A small AR model (d 32, 2+2 layers, r 2, every dropout 0) with GST on the
same weights in both packages (tests/torch_port_pair.build_ar_pair). The
style token attention's dropout is fixed at 0.1 in both packages; the
train-mode tests set it to 0 on both sides (the JAX module's through its
``MultiHeadAttention``). Modules at 1e-5, the whole model and synthesis at
1e-4, the train step with the AR step's rules (tests/test_torch_port_ar.py).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat.torch_import import (
    convert_transformer_state_dict)
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.infer.synthesize import (
    synthesize_transformer_tts as jax_synthesize)
from transformer_tts_tpu.models import gst as jax_gst
from transformer_tts_tpu.ops import masks as jmasks
from transformer_tts_tpu.train import losses as jax_losses
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState, make_transformer_train_step as jax_step)
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import (
    _Writer, state_dict_from_flax)
from transformer_tts_tpu_torch.compat.torch_import import (
    load_reference_checkpoint)
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_transformer_tts)
from transformer_tts_tpu_torch.models import gst
from transformer_tts_tpu_torch.ops import masks
from transformer_tts_tpu_torch.train import schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_transformer_train_step)

from torch_port_pair import AR, SMALL, _random_params, build_ar_pair, to_np


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
CFG = dict(SMALL, **AR, gst=True)


@pytest.fixture(scope="module")
def pair():
    return build_ar_pair(gst=True)


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _mel(seed, b, t, mel_dim=16):
    return np.random.RandomState(seed).randn(b, t, mel_dim).astype(
        np.float32)


def _style_vars(variables, name="style_embedding"):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def _no_token_dropout(monkeypatch, model):
    """The style token attention at dropout 0 in both packages."""
    real = jax_gst.MultiHeadAttention
    monkeypatch.setattr(jax_gst, "MultiHeadAttention",
                        lambda **kw: real(**dict(kw, dropout=0.0)))
    model.style_embedding.style_token_layer.attention.dropout.p = 0.0


def _permuted_reference_encoder(enc, mel):
    """The idiomatic reading of the conv output, NCHW permuted to
    (B, T', H', C) before the reshape: not the reference's."""
    x = mel[:, None]
    for conv, norm in zip(enc.conv_layers, enc.norm):
        x = torch.relu(norm(conv(x)))
    b, c, t, h = x.shape
    return gst.gru_last(enc.gru, x.permute(0, 2, 3, 1).reshape(b, t, h * c))


# ---- the modules ------------------------------------------------------------

def _wide_reference_encoder(seed=0, mel_dim=80):
    """flax and port ReferenceEncoders at mel 80 (GRU input 2 x 128) on
    the same random weights and BatchNorm statistics."""
    jenc = jax_gst.ReferenceEncoder(mel_dim)
    shapes = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 40, mel_dim)), train=False))
    rs = np.random.RandomState(seed)
    variables = {"params": _random_params(shapes["params"], rs),
                 "batch_stats": _random_params(shapes["batch_stats"], rs)}
    w = _Writer({"re": variables["params"]}, {"re": variables["batch_stats"]})
    enc = gst.ReferenceEncoder(mel_dim)
    for i in range(len(gst.CNN_DIMS)):
        w._put(f"conv_layers.{i}.weight",
               np.asarray(variables["params"][f"conv_{i}"]["kernel"])
               .transpose(3, 2, 0, 1))
        w.batch_norm(("re", f"norm_{i}"), f"norm.{i}")
    w.gru(("re", "gru_cell"), "gru")
    enc.load_state_dict(w.out)
    return jenc, variables, enc.eval()


@pytest.mark.parametrize("mel_dim,t", [(16, 70), (16, 5), (80, 133)])
def test_reference_encoder_matches_jax(pair, mel_dim, t):
    if mel_dim == 16:
        _, _, variables, model = pair
        jenc = jax_gst.ReferenceEncoder(mel_dim)
        jvars = {"params": variables["params"]["style_embedding"][
            "reference_encoder"], "batch_stats": variables["batch_stats"][
            "style_embedding"]["reference_encoder"]}
        enc = model.style_embedding.reference_encoder
    else:
        jenc, jvars, enc = _wide_reference_encoder(mel_dim=mel_dim)
    mel = _mel(1, 3, t, mel_dim)
    ref = jenc.apply(jvars, jnp.asarray(mel), train=False)
    with torch.no_grad():
        ours = enc(torch.as_tensor(mel))
    assert ours.shape == (3, gst.GRU_UNITS)
    _close(ours, ref)


def test_the_permuted_conv_output_fails():
    # at mel 80 the conv output keeps H' = 2 and T' > 1, where the two
    # memory orders of the GRU input differ
    jenc, jvars, enc = _wide_reference_encoder()
    mel = _mel(2, 2, 200, 80)
    ref = np.asarray(jenc.apply(jvars, jnp.asarray(mel), train=False))
    with torch.no_grad():
        wrong = to_np(_permuted_reference_encoder(enc, torch.as_tensor(mel)))
        right = to_np(enc(torch.as_tensor(mel)))
    np.testing.assert_allclose(right, ref, **TOL)
    assert np.abs(wrong - ref).max() > 1e-2


def test_batchnorm2d_train_statistics_match_flax():
    jenc, jvars, enc = _wide_reference_encoder(seed=3)
    mel = _mel(4, 3, 90, 80)
    ref, mutated = jenc.apply(jvars, jnp.asarray(mel), train=True,
                              mutable=["batch_stats"])
    enc.train()
    ours = enc(torch.as_tensor(mel))
    _close(ours, ref)
    for i in range(len(gst.CNN_DIMS)):
        norm, stats = enc.norm[i], mutated["batch_stats"][f"norm_{i}"]
        _close(norm.running_mean, stats["mean"])
        _close(norm.running_var, stats["var"])
        assert int(norm.num_batches_tracked) == 1


def _gru_pair(seed):
    """A flax RNN(GRUCell(8)) over 5-wide inputs and the port's GRU on its
    weights, every bias (``ir`` and ``hn`` among them) non-zero."""
    cell = fnn.RNN(fnn.GRUCell(8, name="cell"))
    shapes = jax.eval_shape(lambda: cell.init(jax.random.PRNGKey(0),
                                              jnp.zeros((2, 4, 5))))
    params = _random_params(shapes["params"], np.random.RandomState(seed))
    assert all(np.abs(params["cell"][g]["bias"]).min() > 0
               for g in ("ir", "iz", "in", "hn"))
    w = _Writer({"rnn": params}, {})
    w.gru(("rnn", "cell"), "")
    port = torch.nn.GRU(5, 8, batch_first=True)
    port.load_state_dict({k[1:]: v for k, v in w.out.items()})
    return cell, params, port


def test_gru_matches_flax_with_nonzero_biases():
    cell, params, port = _gru_pair(5)
    x = _mel(6, 3, 7, 5)
    ref = np.asarray(cell.apply({"params": params}, jnp.asarray(x)))[:, -1]
    with torch.no_grad():
        loop = gst.gru_last(port, torch.as_tensor(x))
        native = port(torch.as_tensor(x))[0][:, -1]   # torch's own GRU
    _close(loop, ref)
    _close(native, ref)


@pytest.mark.parametrize("wrong", ["hn_bias_in_bias_ih", "gates_z_r_n"])
def test_gru_fails_on_the_wrong_layout(wrong):
    cell, params, port = _gru_pair(7)
    x = _mel(8, 3, 7, 5)
    ref = np.asarray(cell.apply({"params": params}, jnp.asarray(x)))[:, -1]
    with torch.no_grad():
        h = port.hidden_size
        if wrong == "hn_bias_in_bias_ih":
            port.bias_ih_l0[2 * h:] += port.bias_hh_l0[2 * h:]
            port.bias_hh_l0[2 * h:] = 0.0
        else:
            for p in (port.weight_ih_l0, port.weight_hh_l0, port.bias_ih_l0,
                      port.bias_hh_l0):
                p.copy_(torch.cat([p[h:2 * h], p[:h], p[2 * h:]]))
        got = to_np(gst.gru_last(port, torch.as_tensor(x)))
    assert np.abs(got - ref).max() > 1e-3


def test_style_token_layer_and_style_embedding_match_jax(pair):
    _, _, variables, model = pair
    svars = _style_vars(variables)
    emb = _mel(9, 3, 1, gst.GRU_UNITS)[:, 0]
    ref, ref_attn = jax_gst.StyleTokenLayer(32).apply(
        {"params": svars["params"]["style_token_layer"]}, jnp.asarray(emb),
        train=False)
    with torch.no_grad():
        ours, attn = model.style_embedding.style_token_layer(
            torch.as_tensor(emb))
    assert ours.shape == (3, 1, 32) and attn.shape == (3, 4, 1, 10)
    _close(ours, ref)
    _close(attn, ref_attn)
    mel = _mel(10, 2, 41)
    ref = jax_gst.StyleEmbedding(16, 32).apply(svars, jnp.asarray(mel),
                                                train=False)
    with torch.no_grad():
        ours = model.style_embedding(torch.as_tensor(mel))
    _close(ours, ref)


# ---- the model --------------------------------------------------------------

def _forward_inputs(t=9):
    rs = np.random.RandomState(11)
    pos_text = np.where(np.arange(10)[None] < np.array([[10], [7]]),
                        np.arange(1, 11)[None], 0).astype(np.int32)
    text = np.where(pos_text > 0, rs.randint(1, 40, (2, 10)), 0)
    trg = _mel(12, 2, t)
    pos_mel = np.where(np.arange(t)[None] < np.array([[t], [5]]),
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    jm = jmasks.create_masks(jnp.asarray(pos_text), jnp.asarray(pos_mel),
                             model="transformer")
    tm = masks.create_masks(torch.as_tensor(pos_text),
                            torch.as_tensor(pos_mel), model="transformer")
    return text.astype(np.int32), trg, jm, tm


@pytest.mark.parametrize("ref_b", [1, 2])
def test_eval_forward_with_ref_mel_matches_jax(pair, ref_b):
    _, jmodel, variables, model = pair
    text, trg, (jsrc, jtrg), (src, tmask) = _forward_inputs()
    ref_mel = _mel(13, ref_b, 60)
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(trg), jsrc,
                       jtrg, ref_mel=jnp.asarray(ref_mel), train=False)
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(), torch.as_tensor(trg), src,
                     tmask, torch.as_tensor(ref_mel))
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)


def test_train_forward_styles_from_trg(monkeypatch):
    _, jmodel, variables, model = build_ar_pair(gst=True)
    _no_token_dropout(monkeypatch, model)
    text, trg, (jsrc, jtrg), (src, tmask) = _forward_inputs()
    ref, mutated = jmodel.apply(
        variables, jnp.asarray(text), jnp.asarray(trg), jsrc, jtrg,
        train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    model.train()
    ours = model(torch.as_tensor(text).long(), torch.as_tensor(trg), src,
                 tmask)
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)
    stats = mutated["batch_stats"]["style_embedding"]["reference_encoder"]
    for i in range(len(gst.CNN_DIMS)):
        norm = model.style_embedding.reference_encoder.norm[i]
        _close(norm.running_mean, stats[f"norm_{i}"]["mean"])
        _close(norm.running_var, stats[f"norm_{i}"]["var"])


def test_gst_without_a_style_mel_raises(pair):
    _, _, _, model = pair
    text, trg, _, (src, tmask) = _forward_inputs()
    text = torch.as_tensor(text).long()
    with torch.no_grad(), pytest.raises(ValueError, match="reference mel"):
        model(text, torch.as_tensor(trg), src, tmask)
    with pytest.raises(ValueError, match="reference mel"):
        synthesize_transformer_tts(model, text, src[:, 0].long(),
                                   max_steps=2)


def _ar_batch(seed=0, b=2, l=12, t=520, mel_dim=16, frames=(500, 301)):
    """A collated AR batch (tests/test_torch_port_ar.py's): T_dec = 259
    decoder groups, on K3's path."""
    rs = np.random.RandomState(seed)
    pos_text = np.where(np.arange(l)[None] < np.array([[l], [l - 3]]),
                        np.arange(1, l + 1)[None], 0).astype(np.int32)
    text = np.where(pos_text > 0, rs.randint(1, 40, (b, l)), 0).astype(
        np.int32)
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    stop = np.ones((b, t), np.float32)
    lengths = np.array([-(-(n + 1) // 2) * 2 for n in frames])[:, None]
    for i, n in enumerate(frames):
        mel[i, 0] = 0.0
        mel[i, 1:n + 1] = rs.randn(n, mel_dim)
        stop[i, :n + 1] = 0.0
    pos_mel = np.where(np.arange(t)[None] < lengths,
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                stop_token=stop)


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
    return jax.jit(jax.grad(loss))(variables["params"])


def test_gst_train_step_matches_jax(monkeypatch):
    warmup = 10
    hp, jmodel, variables, model = build_ar_pair(gst=True,
                                                 warmup_step=warmup)
    _no_token_dropout(monkeypatch, model)
    jhp = JaxHParams(**dict(CFG, warmup_step=warmup))
    batch = _ar_batch()
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    new_jstate, jlogs = jax_step(jmodel, jhp, donate=False)(
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
    assert sorted(logs) == sorted(jlogs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    style = [n for n, _ in model.named_parameters()
             if n.startswith("style_embedding.")]
    assert len(style) == 6 + 12 + 4 + 1 + 8     # conv, BN, GRU, tokens, MHA
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = float(np.abs(want).max())
        if name in style and not name.endswith("bias_hh_l0"):
            assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-8, err_msg=name)
        new, ref = p.detach().numpy(), jnew[name].numpy()
        settled = np.abs(want) > 1e-7
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), jnew[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(value, old[name]), name


@pytest.mark.parametrize("ref_b", [1, 2])
def test_synthesize_with_ref_mel_matches_jax(pair, ref_b):
    _, jmodel, variables, model = pair
    steps, r = 10, 2
    text, _, _, (src, _) = _forward_inputs()
    pos_text = src[:, 0].long() * torch.arange(1, 11)
    ref_mel = _mel(14, ref_b, 50)
    rs = np.random.RandomState(15)
    mean = rs.randn(16).astype(np.float32)
    var = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    # a threshold above every probability: no row stops
    jmel, jlen = jax_synthesize(
        jmodel, variables, jnp.asarray(text), jnp.asarray(pos_text.numpy()),
        None, jnp.asarray(ref_mel), jnp.asarray(mean), jnp.asarray(var),
        max_steps=steps, stop_threshold=1.0)
    mel, lengths = synthesize_transformer_tts(
        model, torch.as_tensor(text).long(), pos_text, torch.as_tensor(mean),
        torch.as_tensor(var), ref_mel=torch.as_tensor(ref_mel),
        max_steps=steps, stop_threshold=1.0)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    _close(mel, jmel, **MODEL_TOL)


def test_reference_state_dict_loads_strictly(pair, tmp_path):
    hp, jmodel, _, model = pair
    path = tmp_path / "network.epoch1"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)
    params, bstats = convert_transformer_state_dict(
        torch.load(path), JaxHParams(**CFG))
    loaded = load_reference_checkpoint(str(path), hp, device="cpu")
    text, trg, (jsrc, jtrg), (src, tmask) = _forward_inputs()
    ref_mel = _mel(16, 1, 33)
    ref = jmodel.apply({"params": params, "batch_stats": bstats},
                       jnp.asarray(text), jnp.asarray(trg), jsrc, jtrg,
                       ref_mel=jnp.asarray(ref_mel), train=False)
    with torch.no_grad():
        ours = loaded(torch.as_tensor(text).long(), torch.as_tensor(trg),
                      src, tmask, torch.as_tensor(ref_mel))
    for name in ("mel_pre", "mel_post", "stop_token"):
        _close(getattr(ours, name), getattr(ref, name), **MODEL_TOL)


def _corpus(tmp_path, n=4, mel_dim=16):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 10)
        base = tmp_path / f"utt{i}.npy"
        t_mel = 2 * t_text + 3
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        # the f0 and energy siblings the default pitch_pred/energy_pred read
        for tail in ("_f0.npy", "_energy.npy"):
            np.save(str(base).replace(".npy", tail),
                    rs.rand(t_mel).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


def test_train_cli_then_synthesis_cli_with_ref_mel(tmp_path, capsys):
    script = _corpus(tmp_path)
    cfg = dict(CFG, batch_size=2, max_epoch=1, save_per_epoch=1,
               warmup_step=10, train_script=script,
               save_dir=str(tmp_path / "ckpt"), text_buckets=(8, 16),
               length_buckets=(32,))
    hp_path = tmp_path / "hparams.py"
    hp_path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    train_cli.main(["--hp_file", str(hp_path), "--device", "cpu",
                    "--max_steps", "2"])
    assert "epoch 1 step 2 " in capsys.readouterr().out
    load_dir = os.path.join(cfg["save_dir"], "epoch_1")
    state = torch.load(os.path.join(load_dir, "model.pt"))
    assert int(state["style_embedding.reference_encoder.norm.0."
                     "num_batches_tracked"]) == 2
    test_script = tmp_path / "test.txt"
    test_script.write_text("".join(open(script).readlines()[:2]))
    mels = []
    for i, seed in enumerate((20, 21)):
        ref = tmp_path / f"ref{i}.npy"
        np.save(ref, _mel(seed, 1, 40)[0] * 3.0)
        out_dir = tmp_path / f"gen{i}"
        synth_cli.main(["--load_name", load_dir, "--test_script",
                        str(test_script), "--save", str(out_dir),
                        "--ref_mel", str(ref), "--device", "cpu"])
        mels.append([np.load(out_dir / f"{j}.npy") for j in range(2)])
    for a, b in zip(*mels):
        assert a.shape[1] == 16 and np.isfinite(a).all()
        n = min(len(a), len(b))
        assert n > 0 and np.abs(a[:n] - b[:n]).max() > 0
