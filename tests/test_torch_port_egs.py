"""The port's learning demonstrations (transformer_tts_tpu_torch/egs/)
against the JAX recipes (egs/synthetic_overfit/run.py,
egs/full_pipeline/run.py, loaded by path as tests/test_learning_demo.py
loads them): the corpus builders write the same bytes, the hparams
writers the same files, the scorers give the same numbers on the same
generated directories, and each recipe runs end to end through the
port's CLIs on the CPU at two epochs. The ``--tiny`` learning bars are
the slow, weekly tests at the end.
"""

import importlib.util
import json
import os
import wave

import numpy as np
import pytest
import torch

from transformer_tts_tpu_torch.config import load_hparams
from transformer_tts_tpu_torch.egs import (
    alignment_scale, full_pipeline, gst_style, multi_speaker,
    synthetic_overfit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_recipe(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_run", os.path.join(REPO, "egs", name, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_overfit():
    return _jax_recipe("synthetic_overfit")


@pytest.fixture(scope="module")
def jax_pipeline():
    return _jax_recipe("full_pipeline")


def _same_tree(got_dir, want_dir):
    """Every file of the two directories byte for byte, the directory's
    own path replaced in the text files (the scripts name their files)."""
    got, want = sorted(os.listdir(got_dir)), sorted(os.listdir(want_dir))
    assert got == want
    for name in got:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if os.path.isdir(g):
            _same_tree(g, w)
            continue
        with open(g, "rb") as fh:
            gb = fh.read()
        with open(w, "rb") as fh:
            wb = fh.read()
        if name.endswith(".txt"):
            gb = gb.replace(got_dir.encode(), b"DIR")
            wb = wb.replace(want_dir.encode(), b"DIR")
        assert gb == wb, name


# ---- the corpus builders and the hparams writers ---------------------------

# the three families' corpora: fs2 and ar share the default one
OVERFIT_CORPORA = {"fs2/ar": {}, "conformer": dict(min_phones=72,
                                                   max_phones=96)}


@pytest.mark.parametrize("family", sorted(OVERFIT_CORPORA))
def test_overfit_corpus_is_the_jax_recipes_byte_for_byte(tmp_path,
                                                         jax_overfit,
                                                         family):
    kw = OVERFIT_CORPORA[family]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_overfit.build_corpus(str(tmp_path / "jax"), **kw)
    synthetic_overfit.build_corpus(str(tmp_path / "port"), **kw)
    assert len(os.listdir(tmp_path / "port")) == 64 * 4 + 2
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_audio_corpus_is_the_jax_recipes_byte_for_byte(tmp_path,
                                                       jax_pipeline):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_pipeline.build_audio_corpus(str(tmp_path / "jax"))
    got = full_pipeline.build_audio_corpus(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and len(got) == 64
    for stem in want:
        np.testing.assert_array_equal(got[stem], want[stem])
        assert got[stem].dtype == want[stem].dtype
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


OVERFIT_EXTRAS = {
    "fs2": {},
    "conformer": dict(encoder_type="conformer", decoder_type="conformer",
                      batch_size=8, text_buckets=(96,),
                      length_buckets=(384,)),
    "ar-tiny-no-flash": dict(model="Transformer", reduction_rate=2,
                             positive_weight=5.0, warmup_step=1000,
                             d_model_encoder=64, d_model_decoder=64,
                             use_flash_attention=False)}


def _same_hparams(got_path, want_path):
    with open(got_path) as fh:
        got = fh.read()
    with open(want_path) as fh:
        want = fh.read()
    assert got == want
    assert (load_hparams(got_path).as_dict()
            == load_hparams(want_path).as_dict())


@pytest.mark.parametrize("extra", sorted(OVERFIT_EXTRAS))
def test_overfit_hparams_are_the_jax_recipes(tmp_path, jax_overfit, extra):
    want = jax_overfit.write_hparams(str(tmp_path), str(tmp_path / "ckpt"),
                                     400, OVERFIT_EXTRAS[extra])
    os.rename(want, tmp_path / "jax.py")
    got = synthetic_overfit.write_hparams(str(tmp_path),
                                          str(tmp_path / "ckpt"), 400,
                                          OVERFIT_EXTRAS[extra])
    _same_hparams(got, str(tmp_path / "jax.py"))


@pytest.mark.parametrize("extra", ["variance", "tiny-hifigan"])
def test_acoustic_hparams_are_the_jax_recipes(tmp_path, jax_pipeline,
                                              extra):
    feats = str(tmp_path / "feats")
    more = (dict(pitch_pred=True, energy_pred=True,
                 p_scheduled_sampling=0.5, f0_mean=180.5, f0_std=31.25,
                 energy_mean=12.0, energy_std=3.5)
            if extra == "variance" else
            dict(d_model_encoder=64, vocoder_convnext_channels=32,
                 vocoder_resblock_dilations=((1, 3),),
                 vocoder_type="hifigan"))
    want, want_cfg = jax_pipeline.write_acoustic_hparams(
        str(tmp_path), feats, str(tmp_path / "ckpt"), 600, more,
        name="jax.py")
    got, got_cfg = full_pipeline.write_acoustic_hparams(
        str(tmp_path), feats, str(tmp_path / "ckpt"), 600, more)
    assert got_cfg == want_cfg
    _same_hparams(got, want)


def test_split_scripts_as_the_jax_recipe(tmp_path, jax_pipeline):
    lines = [f"/x/utt{i}.npy|{i} {i + 1}" for i in range(12)]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "train_script.txt").write_text(
            "\n".join(lines) + "\n\n")
    want = jax_pipeline.split_scripts(str(tmp_path / "jax"))
    got = full_pipeline.split_scripts(str(tmp_path / "port"))
    assert got == want == lines
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


# ---- the scorers on the same generated directories -------------------------

def _mels_like(refs, seed):
    """Generated mels against ``refs``: none, shorter, as long, longer."""
    rs = np.random.RandomState(seed)
    out = []
    for i, ref in enumerate(refs):
        n = [0, ref.shape[0] // 2, ref.shape[0], ref.shape[0] + 7][i % 4]
        out.append((ref[:min(n, ref.shape[0])].mean(0, keepdims=True)
                    + rs.randn(n, ref.shape[1])).astype(np.float32)
                   if n else np.zeros((0, ref.shape[1]), np.float32))
    return out


def test_score_matches_the_jax_recipes(tmp_path, jax_overfit):
    work = str(tmp_path)
    synthetic_overfit.build_corpus(work, n_utts=8)
    with open(os.path.join(work, "test.txt")) as fh:
        refs = [np.load(ln.split("|")[0]) for ln in fh if ln.strip()]
    gen = tmp_path / "gen"
    gen.mkdir()
    mels = _mels_like(refs, 1)
    mels[0] = refs[0][:5] + 0.1       # MCD needs a frame: only 4 is empty
    for i, mel in enumerate(mels):
        np.save(gen / f"{i}.npy", mel)
    want = jax_overfit.score(work, str(gen))
    got = synthetic_overfit.score(work, str(gen))
    assert sorted(got) == sorted(want) and got["n"] == want["n"] == 8
    for key in ("mel_l1", "mcd", "len_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_mel_scores_match_the_jax_recipes(tmp_path, jax_pipeline):
    feats, gen = tmp_path / "feats", tmp_path / "gen"
    feats.mkdir()
    gen.mkdir()
    rs = np.random.RandomState(2)
    refs = [rs.randn(int(rs.randint(40, 90)), 80).astype(np.float32) - 5
            for _ in range(8)]
    for i, (ref, mel) in enumerate(zip(refs, _mels_like(refs, 3))):
        np.save(feats / f"utt{i}.npy", ref)
        np.save(gen / f"{i}.npy", mel)
    want = jax_pipeline.mel_scores(str(gen), str(feats))
    got = full_pipeline.mel_scores(str(gen), str(feats))
    assert got["n"] == want["n"] == 8
    np.testing.assert_allclose(got["mel_l1"], want["mel_l1"], rtol=1e-6)


def _write_wav(path, audio):
    with wave.open(str(path), "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(full_pipeline.SR)
        fh.writeframes(np.clip(audio * 32767, -32767, 32767)
                       .astype(np.int16).tobytes())


def test_audio_scores_match_the_jax_recipes(tmp_path, jax_pipeline):
    work = tmp_path / "work"
    (work / "wavs").mkdir(parents=True)
    gen = tmp_path / "gen"
    gen.mkdir()
    rs = np.random.RandomState(4)
    for i in range(8):
        phones = rs.randint(1, full_pipeline.VOCAB, 6)
        ref = np.concatenate([full_pipeline.phone_wave(int(p), 4)
                              for p in phones])
        _write_wav(work / "wavs" / f"utt{i}.wav", ref)
        if i == 3:
            continue                  # no audio: scored as silence
        # shorter, as long, longer; a tone of other phones, with noise
        n = len(ref) * [1, 2, 2, 3][i % 4] // 2
        fake = np.resize(np.concatenate(
            [full_pipeline.phone_wave(int(p), 4) for p in phones[::-1]]), n)
        _write_wav(gen / f"{i}.wav", 0.8 * fake + 0.01 * rs.randn(n))
    want = jax_pipeline.audio_scores(str(gen), "unused", str(work))
    got = full_pipeline.audio_scores(str(gen), "unused", str(work),
                                     device="cpu")
    assert got["n"] == want["n"] == 8
    for key in ("mel_l1", "mcd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


# ---- the recipes end to end through the port's CLIs ------------------------

def _run(main, argv, capsys, key="baseline_mel_l1"):
    """Run a recipe; at two epochs its bar may be missed, which it raises
    after printing the summary. -> the printed summary."""
    try:
        main(argv)
    except AssertionError as err:
        assert "did not learn" in str(err) or "quality bar" in str(err)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"' + key)]
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("family", ["fs2", "conformer", "ar"])
def test_synthetic_overfit_runs_through_the_port_clis(tmp_path, capsys,
                                                      family):
    work = tmp_path / "work"
    summary = _run(synthetic_overfit.main,
                   ["--tiny", "--max_epoch", "2", "--device", "cpu",
                    "--family", family, "--workdir", str(work)], capsys)
    assert summary["family"] == family and summary["epochs"] == 2
    # 64 utterances: 4 batches of 16 an epoch, 8 of 8 for the conformer
    assert summary["steps"] == (16 if family == "conformer" else 8)
    for key in ("baseline_mel_l1", "trained_mel_l1", "trained_mcd"):
        assert np.isfinite(summary[key]) and summary[key] > 0, key


def test_synthetic_overfit_keeps_its_checkpoints_and_averages(tmp_path,
                                                              capsys):
    work = tmp_path / "work"
    _run(synthetic_overfit.main,
         ["--tiny", "--max_epoch", "3", "--device", "cpu", "--keep",
          "--no_flash", "--workdir", str(work)], capsys)
    ckpt = work / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == [
        "average_epoch1-epoch3", "epoch_1", "epoch_2", "epoch_3", "logs"]
    assert load_hparams(str(ckpt / "hparams.py")).use_flash_attention \
        is False
    assert len(list((work / "gen").glob("?.npy"))) == 8


@pytest.mark.parametrize("recipe", ["synthetic_overfit", "full_pipeline"])
def test_bisection_flags_reach_the_trained_hparams(tmp_path, capsys,
                                                   recipe):
    # --fp32 (amp off) and synthetic_overfit's --seed: a missed bar's
    # bisection and the bar's spread over initializations
    work = tmp_path / "work"
    if recipe == "synthetic_overfit":
        _run(synthetic_overfit.main,
             ["--tiny", "--max_epoch", "1", "--device", "cpu", "--keep",
              "--family", "ar", "--fp32", "--seed", "3", "--workdir",
              str(work)], capsys)
        hp = load_hparams(str(work / "ckpt" / "hparams.py"))
        assert hp.seed == 3
    else:
        _run(full_pipeline.main,
             ["--tiny", "--max_epoch", "1", "--voc_steps", "1", "--device",
              "cpu", "--keep", "--fp32", "--workdir", str(work)], capsys)
        hp = load_hparams(str(work / "ckpt" / "hparams.py"))
    assert hp.amp is False


@pytest.mark.parametrize("durations", ["known", "teacher"])
def test_full_pipeline_runs_through_the_port_clis(tmp_path, capsys,
                                                  durations):
    work = tmp_path / "work"
    summary = _run(full_pipeline.main,
                   ["--tiny", "--max_epoch", "2", "--voc_steps", "2",
                    "--durations", durations, "--device", "cpu",
                    "--workdir", str(work)], capsys)
    assert summary["durations"] == durations
    assert summary["epochs"] == 2 and summary["voc_steps"] == 2
    for key in ("baseline_mel_l1", "trained_mel_l1",
                "trained_audio_mel_l1", "copy_synthesis_mel_l1"):
        assert np.isfinite(summary[key]) and summary[key] > 0, key
    if durations == "teacher":
        for key in ("ar_mel_l1", "ar_len_err_mean", "ar_monotonicity",
                    "ar_coverage", "duration_err_frames"):
            assert np.isfinite(summary[key]), key


@pytest.mark.parametrize("argv", [["--post"],
                                  ["--post_variance", "target"]])
def test_full_pipeline_post_is_not_ported_yet(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="Queue 1"):
        full_pipeline.main(argv + ["--workdir", str(tmp_path / "w"),
                                   "--device", "cpu"])
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("recipe", [gst_style, multi_speaker,
                                    alignment_scale],
                         ids=["gst_style", "multi_speaker",
                              "alignment_scale"])
def test_other_recipes_are_not_ported_yet(recipe):
    with pytest.raises(NotImplementedError, match="Queue 1"):
        recipe.main([])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("recipe", [synthetic_overfit, full_pipeline],
                         ids=["synthetic_overfit", "full_pipeline"])
def test_recipes_default_to_the_card(tmp_path, recipe):
    # without --device the first CLI a recipe calls asks for the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe.main(["--tiny", "--max_epoch", "1",
                     "--workdir", str(tmp_path / "w")])


# ---- the --tiny learning bars (weekly) -------------------------------------

@pytest.mark.weekly
@pytest.mark.slow
def test_synthetic_overfit_tiny_learns(tmp_path):
    summary = synthetic_overfit.main(
        ["--tiny", "--max_epoch", "150", "--device", "cpu",
         "--workdir", str(tmp_path / "work")])
    assert (summary["trained_mel_l1"] < 0.2
            or summary["trained_mel_l1"] * 5 < summary["baseline_mel_l1"])


@pytest.mark.weekly
@pytest.mark.slow
def test_full_pipeline_tiny_learns(tmp_path):
    summary = full_pipeline.main(["--tiny", "--device", "cpu",
                                  "--workdir", str(tmp_path / "work")])
    assert (summary["trained_audio_mel_l1"]
            < summary["copy_synthesis_mel_l1"] + 1.5)
