"""The port's vocoder against the JAX package, on the CPU in fp32.

numpy emulations of the three layout rules (flax's "SAME" padding with a
stride, the transposed upsampler's kernel flip and padding, the subpixel
order); the generators (HiFi-GAN subpixel and transposed, odd T, the iSTFT
vocoder) on weights carried from flax, within 1e-5 of max|ref|; the
discriminator's logits and feature maps at N not a multiple of any period;
one GAN step and one fine-tuning step against JAX's
``make_vocoder_train_step`` from the same state (losses 1e-5 relative,
gradients 1e-4 of each tensor's max|g|, the updates by Adam's first-step
rule); the learning-rate schedule against optax; checkpoints; the
synthesis CLI's per-utterance vocoding against the JAX CLI's; and the
``train_vocoder`` and ``synthesize --wav / --vocoder`` CLIs on the CPU.
The discriminator's widths are fixed (32-1024 channels), so the GAN step
runs one period and two scales.
"""

import math
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.vocoder import trainer as jt
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train_vocoder
from transformer_tts_tpu_torch.compat.from_jax import (
    vocoder_state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer.synthesize import vocode_utterance
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.ops.features import read_wav, write_wav
from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
from transformer_tts_tpu_torch.vocoder import trainer as pt
from transformer_tts_tpu_torch.vocoder.discriminator import (
    VocoderDiscriminator, avg_pool_same)
from transformer_tts_tpu_torch.vocoder.generator import (
    SameConv1d, SameConvTranspose1d, conv_transpose_same_padding,
    same_padding)

from torch_port_pair import SMALL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(amp=False, mel_dim=8, vocoder_upsample_rates=(4, 2),
            vocoder_upsample_kernel_sizes=(8, 4), vocoder_channels=16,
            vocoder_resblock_kernel_sizes=(3, 5),
            vocoder_resblock_dilations=((1, 3), (1, 2)),
            vocoder_periods=(2, 3), vocoder_num_scales=2,
            vocoder_segment_size=64, vocoder_convnext_channels=16,
            vocoder_convnext_layers=2, vocoder_convnext_mlp=24,
            vocoder_istft_n_fft=16)
# the GAN step: one period and two scales (the pool between them)
STEP = dict(TINY, vocoder_resblock_kernel_sizes=(3,),
            vocoder_resblock_dilations=((1, 3),), vocoder_periods=(3,))
MEL_CFG = dict(sample_rate=800, n_fft=16, hop_length=8, n_mels=8)
host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731


def _sines(bsz, n, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 800
    return np.stack([0.5 * np.sin(2 * np.pi * 55 * (1 + 0.1 * i) * t)
                     + 0.01 * rs.randn(n) for i in range(bsz)]
                    ).astype(np.float32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- the layout rules -------------------------------------------------------

def test_same_padding_matches_lax():
    for n in (1, 7, 8, 64, 301):
        for k in (1, 3, 4, 5, 15, 41):
            for s, d in ((1, 1), (1, 2), (1, 3), (2, 1), (3, 1), (4, 1)):
                (lo, hi), = lax.padtype_to_pads((n,), ((k - 1) * d + 1,),
                                                (s,), "SAME")
                assert same_padding(n, k, s, d) == (lo, hi), (n, k, s, d)


def _np_conv_transpose(x, kernel, s, pad):
    """lax.conv_transpose without a flip, in numpy: x (T, in), kernel
    (k, in, out); the input dilated by s, padded (pad_a, pad_b), and
    correlated with the kernel."""
    t, c_in = x.shape
    k = kernel.shape[0]
    dil = np.zeros(((t - 1) * s + 1, c_in), x.dtype)
    dil[::s] = x
    dil = np.pad(dil, (pad, (0, 0)))
    n_out = dil.shape[0] - k + 1
    return np.stack([np.einsum("ki,kio->o", dil[j:j + k], kernel)
                     for j in range(n_out)])


@pytest.mark.parametrize("k,s,t", [(16, 8, 5), (4, 2, 7), (3, 2, 4),
                                   (5, 3, 3), (2, 2, 3)])
def test_transposed_upsampler_is_flax_conv_transpose(k, s, t):
    rs = np.random.RandomState(k + s)
    x = rs.randn(t, 3).astype(np.float32)
    kernel = rs.randn(k, 3, 2).astype(np.float32)
    pad = conv_transpose_same_padding(k, s)
    want = _np_conv_transpose(x, kernel, s, pad)
    flax_out = np.asarray(lax.conv_transpose(
        jnp.asarray(x[None]), jnp.asarray(kernel), (s,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC")))[0]
    np.testing.assert_allclose(flax_out, want, rtol=1e-5, atol=1e-5)
    assert want.shape[0] == t * s
    conv = SameConvTranspose1d(3, 2, k, s)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(kernel[::-1].transpose(1, 2, 0)
                                          .copy()))
        conv.bias.zero_()
        got = conv(torch.as_tensor(x.T[None].copy()))[0].numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_subpixel_order_is_flax_reshape():
    # NLC (B, T, r*ch) -> (B, T*r, ch): channel j*ch + c is sample j of c
    rs = np.random.RandomState(0)
    b, t, r, ch = 2, 5, 4, 3
    nlc = rs.randn(b, t, r * ch).astype(np.float32)
    want = nlc.reshape(b, t * r, ch)
    for j in range(r):
        for c in range(ch):
            np.testing.assert_array_equal(want[:, j::r, c],
                                          nlc[:, :, j * ch + c])
    x = torch.as_tensor(nlc.transpose(0, 2, 1).copy())     # NCL
    got = x.view(b, r, ch, t).permute(0, 2, 3, 1).reshape(b, ch, t * r)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), want)


@pytest.mark.parametrize("n", [300, 301, 302, 7])
def test_avg_pool_same_matches_flax(n):
    import flax.linen as nn
    x = np.random.RandomState(n).randn(2, n).astype(np.float32)
    want = np.asarray(nn.avg_pool(jnp.asarray(x)[..., None], (4,),
                                  strides=(2,), padding="SAME"))[..., 0]
    got = avg_pool_same(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_same_conv_pads_the_odd_sample_on_the_right():
    conv = SameConv1d(1, 1, 4, stride=2)
    with torch.no_grad():
        conv.weight.fill_(1.0)
        conv.bias.zero_()
        out = conv(torch.arange(1.0, 8.0)[None, None])[0, 0]
    # n 7, out 4, total pad 3: one zero left, two right
    assert out.tolist() == [6.0, 14.0, 22.0, 13.0]


# ---- the modules on flax's weights -----------------------------------------

def _flax_params(module, *args, seed=0, scale=0.3):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        if path[-1].key == "kernel":
            return (rs.randn(*x.shape) / math.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if path[-1].key == "gamma":
            return (0.5 + 0.1 * rs.randn(*x.shape)).astype(np.float32)
        base = 1.0 if "scale" in path[-1].key else 0.0
        return (base + scale * rs.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("vtype,mode,t", [
    ("hifigan", "subpixel", 12), ("hifigan", "transposed", 12),
    ("hifigan", "subpixel", 13), ("hifigan", "transposed", 13),
    ("istft", "subpixel", 13)])
def test_generator_matches_jax(vtype, mode, t):
    cfg = dict(TINY, vocoder_type=vtype, vocoder_upsample_mode=mode)
    hp = HParams(**cfg)
    jgen = jt.build_vocoder(JaxHParams(**cfg))
    mel = np.random.RandomState(t).randn(2, t, 8).astype(np.float32)
    params = _flax_params(jgen, jnp.asarray(mel))
    ref = np.asarray(jgen.apply({"params": params}, jnp.asarray(mel)))
    gen = pt.build_vocoder(hp, device="cpu")
    gen.load_state_dict(vocoder_state_dict_from_flax(params, hp))
    with torch.no_grad():
        got = gen(torch.as_tensor(mel))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, t * 8)
    assert _rel(got.numpy(), ref) <= 1e-5



@pytest.mark.parametrize("vtype,buckets", [
    ("hifigan", ()), ("hifigan", (8, 16, 32)), ("istft", (16,))])
def test_vocode_utterance_matches_jax_cli(tmp_path, vtype, buckets):
    # the synthesis CLI's per-utterance vocoding (T = 13 padded to a
    # bucket, the generator, the cut to T * hop) against the JAX CLI's
    # ``_write_wav`` on the same weights: the two 16-bit WAVs within one
    # step of the PCM scale
    from transformer_tts_tpu.cli.synthesize import _write_wav
    cfg = dict(TINY, vocoder_type=vtype, length_buckets=buckets)
    hp, jhp = HParams(**cfg), JaxHParams(**cfg)
    jgen = jt.build_vocoder(jhp, train_dtype=jnp.float32)
    mel = np.random.RandomState(3).randn(13, 8).astype(np.float32)
    params = _flax_params(jgen, jnp.asarray(mel[None]))
    _write_wav(str(tmp_path / "ref.wav"), mel, jhp, 800, 8,
               vocoder=(jgen, jax.jit(jgen.apply), {"params": params}),
               buckets=buckets)
    gen = pt.build_vocoder(hp, device="cpu").eval()
    gen.load_state_dict(vocoder_state_dict_from_flax(params, hp))
    got = vocode_utterance(gen, torch.as_tensor(mel), hp.length_buckets)
    assert got.dtype == torch.float32 and got.shape == (13 * 8,)
    write_wav(str(tmp_path / "got.wav"), got.numpy(), 800)
    pcm = [np.frombuffer(wave.open(str(tmp_path / f"{name}.wav")).readframes(
        13 * 8), np.int16).astype(np.int32) for name in ("got", "ref")]
    assert pcm[0].shape == pcm[1].shape == (13 * 8,)
    assert np.abs(pcm[0] - pcm[1]).max() <= 1 and np.abs(pcm[1]).max() > 100


def test_generator_under_amp_gives_fp32():
    gen = pt.build_vocoder(HParams(**dict(TINY, amp=True)), device="cpu")
    with torch.no_grad():
        wav = gen(torch.randn(1, 6, 8))
    assert wav.dtype == torch.float32 and wav.shape == (1, 48)
    assert bool((wav.abs() <= 1.0).all())


def test_istft_head_runs_in_fp32_under_amp():
    gen = pt.build_vocoder(HParams(**dict(TINY, amp=True,
                                          vocoder_type="istft")),
                           device="cpu")
    seen = []
    gen.head.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        wav = gen(torch.randn(1, 6, 8))
    assert seen == [torch.float32] and wav.dtype == torch.float32


def test_discriminator_matches_jax():
    hp = HParams(**TINY)
    jdisc = jt.build_discriminator(JaxHParams(**TINY))
    audio = (np.random.RandomState(1).randn(2, 301) * 0.3).astype(np.float32)
    params = _flax_params(jdisc, jnp.asarray(audio))
    ref = jdisc.apply({"params": params}, jnp.asarray(audio))
    disc = VocoderDiscriminator(hp.vocoder_periods, hp.vocoder_num_scales)
    disc.load_state_dict(vocoder_state_dict_from_flax(params, hp,
                                                      discriminator=True))
    with torch.no_grad():
        got = disc(torch.as_tensor(audio))
    assert len(got) == len(ref) == 4
    for (logits, fmaps), (rlogits, rfmaps) in zip(got, ref):
        assert logits.shape == rlogits.shape
        assert _rel(logits.numpy(), np.asarray(rlogits)) <= 1e-5
        assert len(fmaps) == len(rfmaps)
        for f, rf in zip(fmaps, rfmaps):
            f = np.moveaxis(f.numpy(), 1, -1)    # NCHW / NCL -> flax's
            assert f.shape == rf.shape
            assert _rel(f, np.asarray(rf)) <= 1e-5


# ---- the GAN step ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """JAX's vocoder state at STEP's size with random weights (shapes by
    eval_shape, not a CPU init of the 1024-wide discriminator)."""
    jhp = JaxHParams(**STEP)
    made = {}

    def init():
        state, gen, disc = jt.init_vocoder_state(jhp, jax.random.PRNGKey(0),
                                                 64)
        made["modules"] = (gen, disc)
        return state
    shapes = jax.eval_shape(init)
    rs = np.random.RandomState(3)

    def leaf(path, x):
        keys = {getattr(p, "name", getattr(p, "key", None)) for p in path}
        if keys & {"g_params", "d_params"}:
            name = path[-1].key
            if name == "kernel":
                return jnp.asarray((rs.randn(*x.shape) / math.sqrt(
                    np.prod(x.shape[:-1]))).astype(np.float32))
            base = 1.0 if "scale" in name else 0.0
            return jnp.asarray((base + 0.1 * rs.randn(*x.shape)).astype(
                np.float32))
        return jnp.zeros(x.shape, x.dtype)
    return jhp, jax.tree_util.tree_map_with_path(leaf, shapes), made[
        "modules"]


def _jax_grads(gen, disc, jhp, finetune):
    """The gradients of JAX's step, jitted: D's loss at the old weights,
    G's at the old G and the updated D (vocoder/trainer.py:169-200)."""
    hop = gen.hop_length

    def mel_of(a):
        from transformer_tts_tpu.ops.melspectrogram import (
            log_mel_spectrogram)
        return log_mel_spectrogram(a, **MEL_CFG)[:, : a.shape[1] // hop]

    def grads(g_params, d_params, new_d_params, audio, in_mel):
        mel = mel_of(audio)
        gen_in = in_mel if finetune else mel
        fake = gen.apply({"params": g_params}, gen_in)

        def d_loss(dp):
            return (sum(jnp.mean((lr - 1.0) ** 2)
                        for lr, _ in disc.apply({"params": dp}, audio))
                    + sum(jnp.mean(lf ** 2)
                          for lf, _ in disc.apply({"params": dp}, fake)))

        def g_loss(gp):
            wav = gen.apply({"params": gp}, gen_in)
            outs_f = disc.apply({"params": new_d_params}, wav)
            outs_r = disc.apply({"params": new_d_params}, audio)
            fm = sum(jnp.mean(jnp.abs(fr - ff))
                     for (_, mr), (_, mf) in zip(outs_r, outs_f)
                     for fr, ff in zip(mr, mf))
            return (sum(jnp.mean((lf - 1.0) ** 2) for lf, _ in outs_f)
                    + jhp.vocoder_lambda_fm * fm + jhp.vocoder_lambda_mel
                    * jnp.mean(jnp.abs(mel_of(wav) - mel)))
        return jax.grad(d_loss)(d_params), jax.grad(g_loss)(g_params)
    return jax.jit(grads)


def _check_update(name, new, old, ref, grad, ref_grad, lr):
    # Adam's first step moves each element by lr*g/(|g| + 1e-8): where the
    # two gradients do not bound their difference (rounding noise around
    # 0) it is any value in [-lr, lr] in either package
    settled = np.abs(ref_grad) > np.maximum(1e-7, 10 * np.abs(grad
                                                              - ref_grad))
    np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                               atol=1e-6, err_msg=name)
    moved = np.abs(new - old)
    assert np.all(moved <= lr * 1.0001 + 2 * np.spacing(np.abs(old))), name


@pytest.fixture(scope="module")
def steps(jax_state):
    """finetune -> one step of each package from the same state and audio
    (JAX's new state and scalars, the port's state and scalars, the
    port's weights before the step, the inputs), run on first use."""
    jhp, jstate, (jgen, jdisc) = jax_state
    hp = HParams(**STEP)
    done = {}

    def run(finetune):
        if finetune in done:
            return done[finetune]
        audio = _sines(2, 64)
        in_mel = (np.random.RandomState(4).randn(2, 8, 8) - 3).astype(
            np.float32) if finetune else None
        extra = [in_mel] if finetune else []
        step = jt.make_vocoder_train_step(jgen, jdisc, jhp, MEL_CFG,
                                          predicted_mel_inputs=finetune)
        # the step donates its state: hand it a copy
        new, jlogs = step(jax.tree.map(jnp.copy, jstate),
                          *[jnp.asarray(x) for x in [audio] + extra],
                          jax.random.PRNGKey(1))
        state = pt.init_vocoder_state(hp, 64, device="cpu")
        state.generator.load_state_dict(_port_tree(hp, "generator",
                                                   jstate.g_params))
        state.discriminator.load_state_dict(_port_tree(hp, "discriminator",
                                                       jstate.d_params))
        old = {role: {k: v.detach().clone() for k, v in
                      getattr(state, role).named_parameters()}
               for role in ("generator", "discriminator")}
        logs = pt.make_vocoder_train_step(hp, MEL_CFG,
                                          predicted_mel_inputs=finetune)(
            state, *[torch.as_tensor(x) for x in [audio] + extra])
        done[finetune] = (new, jlogs, state, logs, old, audio, in_mel)
        return done[finetune]
    return run


def _port_tree(hp, role, tree):
    return vocoder_state_dict_from_flax(host(tree), hp,
                                        discriminator=role == "discriminator")


@pytest.mark.parametrize("finetune", [False, True])
def test_gan_step_losses_and_updates_match_jax(steps, finetune):
    new, jlogs, state, logs, old, _, _ = steps(finetune)
    hp = HParams(**STEP)
    assert state.step == 1
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    lr = pt.vocoder_schedule(hp)(0)
    for role, tree in (("generator", new.g_params),
                       ("discriminator", new.d_params)):
        ref_new = _port_tree(hp, role, tree)
        for name, p in getattr(state, role).named_parameters():
            g = p.grad.numpy()      # the gradients: the next test
            _check_update(f"{role} {name}", p.detach().numpy(),
                          old[role][name].numpy(), ref_new[name].numpy(),
                          g, g, lr)


@pytest.mark.parametrize("finetune", [False, True])
def test_gan_step_gradients_match_jax(jax_state, steps, finetune):
    jhp, jstate, (jgen, jdisc) = jax_state
    new, _, state, _, old, audio, in_mel = steps(finetune)
    hp = HParams(**STEP)
    d_grads, g_grads = _jax_grads(jgen, jdisc, jhp, finetune)(
        jstate.g_params, jstate.d_params, new.d_params, jnp.asarray(audio),
        jnp.asarray(in_mel) if finetune else None)
    lr = pt.vocoder_schedule(hp)(0)
    for role, grads, tree in (("generator", g_grads, new.g_params),
                              ("discriminator", d_grads, new.d_params)):
        want_grads = _port_tree(hp, role, grads)
        ref_new = _port_tree(hp, role, tree)
        for name, p in getattr(state, role).named_parameters():
            want = want_grads[name].numpy()
            got = p.grad.numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                err_msg=f"{role} {name}")
            _check_update(f"{role} {name}", p.detach().numpy(),
                          old[role][name].numpy(), ref_new[name].numpy(),
                          got, want, lr)


def test_step_wants_the_mel_exactly_in_fine_tuning():
    hp = HParams(**STEP)
    state = pt.init_vocoder_state(hp, 64, device="cpu")
    audio = torch.as_tensor(_sines(1, 64))
    with pytest.raises(ValueError, match="predicted_mel_inputs"):
        pt.make_vocoder_train_step(hp, MEL_CFG)(state, audio,
                                                torch.zeros(1, 8, 8))
    with pytest.raises(ValueError, match="predicted_mel_inputs"):
        pt.make_vocoder_train_step(hp, MEL_CFG, predicted_mel_inputs=True)(
            state, audio)


@pytest.mark.parametrize("count", [0, 1, 999, 2500, 123456])
def test_learning_rate_matches_optax(count):
    hp = HParams(**STEP)
    sched = optax.exponential_decay(hp.vocoder_lr, hp.vocoder_lr_decay_steps,
                                    hp.vocoder_lr_decay)
    # optax evaluates the power in fp32
    assert pt.vocoder_schedule(hp)(count) == pytest.approx(
        float(sched(count)), rel=1e-5)


def test_checkpoint_and_export_round_trip(tmp_path):
    hp = HParams(**STEP)
    state = pt.init_vocoder_state(hp, 64, device="cpu")
    step = pt.make_vocoder_train_step(hp, MEL_CFG)
    step(state, torch.as_tensor(_sines(2, 64)))
    pt.save_vocoder_checkpoint(str(tmp_path), state, 1)
    export = pt.export_generator(str(tmp_path), state)
    other = pt.init_vocoder_state(hp, 64, device="cpu", seed=5)
    pt.restore_vocoder_checkpoint(str(tmp_path), other)
    assert other.step == 1
    for role in ("generator", "discriminator"):
        for (k, a), (_, b) in zip(
                getattr(state, role).state_dict().items(),
                getattr(other, role).state_dict().items()):
            assert torch.equal(a, b), k
    assert (other.g_opt.state_dict()["state"][0]["exp_avg"].equal(
        state.g_opt.state_dict()["state"][0]["exp_avg"]))
    for path in (export, str(tmp_path / "vocoder_1")):
        got = pt.restore_generator_params(path)
        for k, v in state.generator.state_dict().items():
            assert torch.equal(got[k], v), k
    # a resumed step continues where the saved one would have
    a = step(state, torch.as_tensor(_sines(2, 64, seed=2)))
    b = step(other, torch.as_tensor(_sines(2, 64, seed=2)))
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---- the CLIs --------------------------------------------------------------

def _wav_corpus(tmp_path, rate=800):
    lines = []
    for i, n in enumerate((300, 500, 40)):     # the last one is tiled
        path = tmp_path / f"v{i}.wav"
        write_wav(str(path), _sines(1, n, seed=i)[0], rate)
        lines.append(str(path))
    script = tmp_path / "wavs.txt"
    script.write_text("\n".join(lines) + "\n")
    return str(script)


def _write_hp(tmp_path, **extra):
    path = tmp_path / "hp.py"
    cfg = dict(STEP, save_dir=str(tmp_path / "voc"), **extra)
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path)


VOC_ARGS = ["--sample_rate", "800", "--n_fft", "16", "--batch_size", "2",
            "--device", "cpu"]


def test_train_vocoder_cli_then_synthesis_cli(tmp_path, capsys):
    script = _wav_corpus(tmp_path)
    train_vocoder.main(["--hp_file", _write_hp(tmp_path), "--wav_script",
                        script, "--max_steps", "3", "--save_every", "2",
                        *VOC_ARGS])
    out = capsys.readouterr().out
    assert "loaded 3 wavs" in out and "loss_mel=" in out
    voc = tmp_path / "voc"
    assert (voc / "vocoder_2" / "generator.pt").exists()
    assert (voc / "vocoder_3" / "train_state.pt").exists()
    assert (voc / "logs" / "train.jsonl").read_text().count("\n") == 2

    # resume from vocoder_2 and run to step 4
    train_vocoder.main(["--hp_file", _write_hp(
        tmp_path, loaded_dir=str(voc), loaded_epoch=2),
        "--wav_script", script, "--max_steps", "4", "--save_every", "10",
        *VOC_ARGS])
    assert "resumed at step 2" in capsys.readouterr().out
    assert (voc / "vocoder_4").exists()

    # FastSpeech 2 at SMALL's width with the vocoder's mel_dim and hop
    cfg = dict(SMALL, **STEP, text_buckets=(8, 16))
    model_dir = tmp_path / "model"
    model = build_fastspeech2(HParams(**cfg), device="cpu")
    with torch.no_grad():           # ~3 frames per phone
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            math.log(4.0))
    save_checkpoint(model, str(model_dir))
    (model_dir / "hparams.py").write_text(
        "".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    test_script = tmp_path / "test.txt"
    test_script.write_text("a.npy|3 5 7 9\nb.npy|1 2 3 4 5 6\n")
    for flags, name in ((["--vocoder", str(voc / "generator")], "vocoded"),
                        (["--wav", "--n_fft", "16", "--hop_length", "8"],
                         "griffin_lim")):
        out_dir = tmp_path / name
        synth_cli.main(["--load_name", str(model_dir), "--test_script",
                        str(test_script), "--save", str(out_dir),
                        "--max_frames", "24", "--sample_rate", "800",
                        "--device", "cpu", *flags])
        for idx in range(2):
            mel = np.load(out_dir / f"{idx}.npy")
            audio, rate = read_wav(str(out_dir / f"{idx}.wav"))
            assert rate == 800 and np.isfinite(audio).all()
            hop_frames = mel.shape[0] if name == "vocoded" \
                else mel.shape[0] - 1
            assert audio.shape == (hop_frames * 8,)
            with wave.open(str(out_dir / f"{idx}.wav")) as fh:
                assert fh.getsampwidth() == 2 and fh.getnchannels() == 1
    if name == "griffin_lim":
        assert np.abs(audio).max() == pytest.approx(0.95, abs=1e-4)


def test_vocoder_cli_fine_tunes_on_predicted_mels(tmp_path, capsys):
    script = _wav_corpus(tmp_path)
    lines = []
    for i, path in enumerate(open(script).read().split()):
        n_frames = len(read_wav(path)[0]) // 8
        mel_path = tmp_path / f"m{i}.npy"
        np.save(mel_path, np.random.RandomState(i).randn(
            n_frames, 8).astype(np.float32))
        lines.append(f"{path}|{mel_path}")
    mel_script = tmp_path / "mels.txt"
    mel_script.write_text("\n".join(lines) + "\n")
    train_vocoder.main(["--hp_file", _write_hp(tmp_path), "--wav_script",
                        script, "--mel_script", str(mel_script),
                        "--max_steps", "2", *VOC_ARGS])
    assert "fine-tune on predicted mels" in capsys.readouterr().out
    assert (tmp_path / "voc" / "generator" / "generator.pt").exists()


def test_new_clis_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = _wav_corpus(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vocoder.main(["--hp_file", _write_hp(tmp_path), "--wav_script",
                            script, "--max_steps", "1"])
    for fn in (pt.build_vocoder, pt.build_discriminator):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(HParams(**STEP))
