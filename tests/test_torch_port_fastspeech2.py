"""The port's FastSpeech 2 slice against the JAX package, on the CPU in fp32.

Whole forward and ``synthesize_fastspeech2`` at 1e-4 abs/rel (twelve
layers of fp32 sums in different orders), the weight round trip, the
synthesis CLI, and the options that belong to later slices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat.torch_import import (
    convert_fastspeech2_state_dict)
from transformer_tts_tpu.infer.synthesize import (
    synthesize_fastspeech2 as jax_synthesize)
from transformer_tts_tpu.ops.masks import pad_mask as jax_pad_mask
from transformer_tts_tpu_torch.cli import synthesize as cli
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_fastspeech2)
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops.masks import pad_mask
from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_pair import SMALL, build_pair, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _batch(seed, b=2, l=12, vocab=40):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, vocab, (b, l)).astype(np.int32)
    text[1, l - 3:] = 0
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    return text, pos


def test_weight_round_trip(pair):
    hp, _, variables, model = pair
    params, bstats = convert_fastspeech2_state_dict(model.state_dict(), hp)
    assert (jax.tree.structure(params)
            == jax.tree.structure(variables["params"]))
    for got, want in ((params, variables["params"]),
                      (bstats, variables["batch_stats"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("options", [
    {}, {"concat_after_encoder": True, "concat_after_decoder": True},
    {"postnet_pred": False}, {"pitch_pred": False, "energy_pred": False},
    {"f0_mean": 200.0, "f0_std": 50.0, "energy_mean": 100.0,
     "energy_std": 30.0}])
def test_forward_teacher_forced_matches_jax(pair, options):
    _, jmodel, variables, model = build_pair(**options) if options else pair
    text, pos = _batch(1)
    rs = np.random.RandomState(2)
    t = 48
    d = rs.randint(0, 5, text.shape).astype(np.int32) * (text != 0)
    p = rs.uniform(60, 800, (2, t)).astype(np.float32)
    e = rs.uniform(0, 320, (2, t)).astype(np.float32)
    apply = jax.jit(jmodel.apply, static_argnums=3,
                    static_argnames="train")
    ref = apply(variables, jnp.asarray(text), jax_pad_mask(jnp.asarray(pos)),
                t, jnp.asarray(d), jnp.asarray(p), jnp.asarray(e),
                train=False)
    with torch.no_grad():
        ours = model(torch.as_tensor(text), pad_mask(torch.as_tensor(pos)),
                     t, torch.as_tensor(d), torch.as_tensor(p),
                     torch.as_tensor(e))
    for field in ("mel_pre", "mel_post", "log_duration", "pitch", "energy",
                  "variance_adaptor_output"):
        if getattr(ref, field) is None:
            assert getattr(ours, field) is None, field
            continue
        # raw-Hz pitch and raw energy are O(100): the same relative
        # tolerance, an absolute one scaled to them
        atol = 1e-2 if field in ("pitch", "energy") else TOL["atol"]
        np.testing.assert_allclose(to_np(getattr(ours, field)),
                                   to_np(getattr(ref, field)),
                                   rtol=TOL["rtol"], atol=atol)
    for field in ("mel_len", "mel_pos"):
        np.testing.assert_array_equal(to_np(getattr(ours, field)),
                                      to_np(getattr(ref, field)))


def _synth_pair(pair, max_frames, text_len, **scales):
    _, jmodel, variables, model = pair
    text, pos = _batch(3, l=text_len)
    rs = np.random.RandomState(4)
    mean = rs.randn(16).astype(np.float32)
    var = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    ref = jax_synthesize(jmodel, variables, jnp.asarray(text),
                         jnp.asarray(pos), max_frames, mean=jnp.asarray(mean),
                         var=jnp.asarray(var), **scales)
    ours = synthesize_fastspeech2(
        model, torch.as_tensor(text), torch.as_tensor(pos), max_frames,
        torch.as_tensor(mean), torch.as_tensor(var), **scales)
    return ours, ref


@pytest.mark.parametrize("scales", [
    {}, {"pitch_scale": 1.2, "duration_scale": 0.8}])
def test_synthesize_matches_jax(pair, scales):
    (mel, mel_len, dur), (rmel, rlen, rdur) = _synth_pair(pair, 64, 12,
                                                          **scales)
    np.testing.assert_array_equal(to_np(mel_len), to_np(rlen))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(rdur))
    assert int(mel_len.min()) > 0
    np.testing.assert_allclose(to_np(mel), to_np(rmel), **TOL)


def test_synthesize_kernel_path_matches_jax_on_valid_frames(pair,
                                                            monkeypatch):
    # max_frames >= 256: the port's decoder attention goes to
    # flash_attention (its plain version on the CPU) while JAX on the CPU
    # runs the masked-fill path. They differ only on rows with no valid
    # key, a batch row with k_len = 0 (0 against the uniform average);
    # padded query rows still attend to the valid keys and agree on both
    # paths. Every row here has frames; the check covers valid frames.
    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    (mel, mel_len, dur), (rmel, rlen, rdur) = _synth_pair(pair, 256, 24)
    assert len(calls) == SMALL["n_layer_decoder"]
    np.testing.assert_array_equal(to_np(mel_len), to_np(rlen))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(rdur))
    for b, n in enumerate(to_np(mel_len).astype(int)):
        assert 0 < n < 256
        np.testing.assert_allclose(to_np(mel[b, :n]), to_np(rmel[b, :n]),
                                   **TOL)


def _write_model_dir(tmp_path, **extra):
    cfg = dict(SMALL, text_buckets=(8, 16), **extra)
    hp_path = tmp_path / "model" / "hparams.py"
    hp_path.parent.mkdir()
    hp_path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    if extra.get("model", "Fastspeech2") == "Fastspeech2":
        save_checkpoint(build_fastspeech2(HParams(**cfg), device="cpu"),
                        str(hp_path.parent))
    elif extra.get("gst") or extra.get("decoder_type") == "tacotron2":
        save_checkpoint(build_transformer_tts(HParams(**cfg), device="cpu"),
                        str(hp_path.parent))
    script = tmp_path / "test.txt"
    script.write_text("a.npy|3 5 7 9\nb.npy|1 2 3 4 5 6 7 8 9 10\nc.npy|4\n")
    return str(hp_path.parent), str(script)


def test_cli_synthesizes_on_cpu(tmp_path, capsys):
    load_dir, script = _write_model_dir(tmp_path)
    out_dir = tmp_path / "out"
    cli.main(["--load_name", load_dir, "--test_script", script,
              "--save", str(out_dir), "--max_frames", "64",
              "--batch_size", "2", "--device", "cpu"])
    for idx, n_text in enumerate((4, 10, 1)):
        mel = np.load(out_dir / f"{idx}.npy")
        align = np.load(out_dir / f"{idx}_alignment.npy")
        assert mel.dtype == np.float32 and mel.shape[1] == 16
        assert mel.shape[0] == min(64, int(align.sum()))
        assert np.isfinite(mel).all()
        assert align[:n_text].min() >= 0 and not align[n_text:].any()
    assert "elapsed time" in capsys.readouterr().out


def test_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    load_dir, script = _write_model_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--load_name", load_dir, "--test_script", script,
                  "--save", str(tmp_path / "out")])


@pytest.mark.parametrize("hp_extra,flags,match", [
    ({"model": "Transformer", "gst": True}, [], "AR"),
    ({}, ["--post_model", "x"], "post-processing"),
    ({"model": "Transformer", "decoder_type": "tacotron2"}, ["--wav"],
     "tacotron2")])
def test_cli_paths_of_later_slices_raise(tmp_path, hp_extra, flags, match):
    load_dir, script = _write_model_dir(tmp_path, **hp_extra)
    args = ["--load_name", load_dir, "--test_script", script, "--save",
            str(tmp_path / "out"), "--device", "cpu", *flags]
    if hp_extra.get("gst"):
        # GST synthesis is ported (tests/test_torch_port_gst.py): the
        # reference mel of --ref_mel styles every utterance
        ref = tmp_path / "ref.npy"
        np.save(ref, np.random.RandomState(0).randn(50, 16).astype(
            np.float32))
        cli.main([*args, "--ref_mel", str(ref)])
        for idx in range(3):
            mel = np.load(tmp_path / "out" / f"{idx}.npy")
            assert mel.shape[1] == 16 and np.isfinite(mel).all()
        return
    if hp_extra.get("decoder_type") == "tacotron2":
        # the Tacotron 2 decoder is ported (tests/test_torch_port_tacotron2
        # .py): its synthesis loop, then Griffin-Lim's waveform; untrained
        # weights rarely stop, so the loop is held to 64 frames, on one
        # intra-op thread (its small steps would otherwise spin against
        # the other test workers for the host's cores)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cli.main([*args, "--max_frames", "64"])
        finally:
            torch.set_num_threads(threads)
        for idx in range(3):
            mel = np.load(tmp_path / "out" / f"{idx}.npy")
            assert mel.shape[1] == 16 and np.isfinite(mel).all()
            assert (tmp_path / "out" / f"{idx}.wav").exists() == (
                len(mel) > 0)
        return
    # --post_model is ported (tests/test_torch_port_post_cli.py holds it
    # against JAX's engine): a v1 student refines every mel
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_post_model)
    student_dir = tmp_path / "x"
    student_hp = HParams(**dict(SMALL, version=1, n_layer_post_model=1))
    save_checkpoint(build_post_model(student_hp, device="cpu"),
                    str(student_dir))
    (student_dir / "hparams.py").write_text("version = 1\nmel_dim = 16\n"
                                            "d_model_encoder = 32\n"
                                            "n_head_encoder = 2\n"
                                            "n_layer_post_model = 1\n"
                                            "amp = False\n")
    args[args.index("x")] = str(student_dir)
    cli.main(args)
    for idx in range(3):
        mel = np.load(tmp_path / "out" / f"{idx}.npy")
        assert mel.shape[1] == 16 and np.isfinite(mel).all()


@pytest.mark.parametrize("option", [
    {"use_pos": True}, {"decoder_type": "tacotron2"},
    {"use_sq_vae": True}, {"use_hop": True},
    {"is_multi_speaker": True, "spk_emb_architecture": "encoder"},
    {"CTC_training": True}, {"architecture": "text-mel-mel"}])
def test_options_of_later_slices_raise(option):
    hp = HParams(**dict(SMALL, **option))
    if option == {"use_sq_vae": True}:
        # the SQ-VAE bottleneck is ported (tests/test_torch_port_sq.py):
        # the model builds with its codebook and synthesizes
        model = build_fastspeech2(hp, device="cpu")
        assert model.codebook.embedding.shape == (128, 32)
        text = torch.tensor([[3, 5, 7, 9]])
        mel, mel_len, _ = synthesize_fastspeech2(
            model, text, torch.arange(1, 5)[None], 32)
        assert mel.shape == (1, 32, 16) and bool(torch.isfinite(mel).all())
        return
    if option.keys() & {"use_pos", "use_hop", "CTC_training"}:
        # ported (tests/test_torch_port_conditioning.py): the model builds
        # and synthesizes
        model = build_fastspeech2(hp, device="cpu")
        kw = {"hop_size": torch.tensor([2])} if hp.use_hop else {}
        mel, _, _ = synthesize_fastspeech2(
            model, torch.tensor([[3, 5, 7, 9]]), torch.arange(1, 5)[None],
            32, **kw)
        assert mel.shape == (1, 32, 16) and bool(torch.isfinite(mel).all())
        return
    if option.get("is_multi_speaker"):
        # speakers are ported; without spk_emb_dim there is no table
        with pytest.raises(ValueError, match="spk_emb_dim"):
            build_fastspeech2(hp, device="cpu")
        return
    if option == {"decoder_type": "tacotron2"}:
        # the Tacotron 2 decoder is ported as the AR model's
        # (tests/test_torch_port_tacotron2.py); FastSpeech 2 refuses it
        with pytest.raises(ValueError, match="AR model's decoder"):
            build_fastspeech2(hp, device="cpu")
        return
    # the text-mel-mel integrate model is ported
    # (tests/test_torch_port_post.py): it builds with its post model and
    # synthesizes the refined mel
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_integrate)
    model = build_fastspeech2(hp, device="cpu")
    assert model.post_model is not None
    refined, prenet, _, _ = synthesize_integrate(
        model, torch.tensor([[3, 5, 7, 9]]), torch.arange(1, 5)[None], 32)
    assert refined.shape == prenet.shape == (1, 32, 16)
    assert bool(torch.isfinite(refined).all())


def test_checkpoint_round_trip(tmp_path):
    from transformer_tts_tpu_torch.train.checkpoint import load_checkpoint
    hp = HParams(**SMALL)
    model = build_fastspeech2(hp, device="cpu", seed=3)
    save_checkpoint(model, str(tmp_path))
    other = load_checkpoint(build_fastspeech2(hp, device="cpu", seed=4),
                            str(tmp_path))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    assert os.path.exists(tmp_path / "model.pt")
