"""The mel-to-mel line's entry points in the PyTorch port, on the CPU:
cli/teacher_forcing.py against the JAX CLI's files, the training CLI's
mel-mel (frozen teacher and pregenerated corpus) and text-mel-mel runs and
its NaN-skip count, the synthesis CLI's ``--post_model`` and integrate
``--save_prenet`` paths, ``TTSEngine(post_model=)`` and a text-mel-mel
engine against JAX's engines, their refusal to stream, the data layer's
new keys, and the export of both engines (artifacts bit for bit against
the engine).

Small models (d 32, 1 + 1 layers, mel 16 or 8), fp32, dropout 0. Mels
within 1e-5 of JAX's unless a test says otherwise.
"""

import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.data import batching as jax_batching
from transformer_tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from transformer_tts_tpu.train import checkpoint as jax_ckpt
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import teacher_forcing as tf_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.data import batching
from transformer_tts_tpu_torch.data.dataset import TTSDataset
from transformer_tts_tpu_torch.data.loader import DataLoader
from transformer_tts_tpu_torch.infer.engine import TTSEngine
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_fastspeech2_post, synthesize_integrate)
from transformer_tts_tpu_torch.models.fastspeech2 import build_post_model
from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_port_post import integrate_pair, student_pair
from test_torch_port_train import _corpus
from torch_port_pair import build_pair, write_engine_checkpoints

MEL = 16
SMALL_POST = dict(vocab_size=40, mel_dim=MEL, mel_dim_post=MEL,
                  d_model_encoder=32, d_model_decoder=32, n_layer_encoder=1,
                  n_layer_decoder=1, n_head_encoder=2, n_head_decoder=2,
                  n_layer_post_model=1, amp=False, dropout=0.0,
                  dropout_postnet=0.0, dropout_variance_adaptor=0.0,
                  warmup_step=10, reference_init=False)
BUCKETS = dict(text_buckets=(8, 16), length_buckets=(32, 64))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_hp(path, **cfg):
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path)


def teacher_dirs(tmp_path, script, **extra):
    """A FastSpeech 2 of SMALL_POST's size in both packages' checkpoint
    formats (``jax/``, ``port/``), their hparams naming ``script`` and
    corpus statistics."""
    cfg = dict(SMALL_POST, train_script=script, **BUCKETS, **extra)
    cfg.pop("mel_dim_post")
    hp, _, variables, model = build_pair(1, **cfg)
    (tmp_path / "teacher").mkdir()
    jax_dir, port_dir = write_engine_checkpoints(
        tmp_path / "teacher", cfg, variables, model, stats_seed=4)
    return hp, variables, model, jax_dir, port_dir


# ---- the data layer --------------------------------------------------------

def test_dataset_and_collate_carry_the_post_keys_as_jax(tmp_path):
    script, extra = _corpus(tmp_path, mel_dim=MEL, normalise=True)
    rs = np.random.RandomState(1)
    for line in open(script):
        name = line.split("|")[0]
        n = np.load(name).shape[0]
        np.save(name.replace(".npy", "_gen.npy"),
                rs.randn(n, MEL).astype(np.float32))
        np.save(name.replace(".npy", "_gen_phone.npy"),
                rs.randn(n, 32).astype(np.float32))
        np.save(name.replace(".npy", "_xvector.npy"),
                rs.randn(12).astype(np.float32))
    cfg = dict(mel_dim=MEL, architecture="mel-mel", teacher_suffix="_gen",
               spk_emb_postprocess_type="x_vector",
               spk_emb_dim_postprocess=12, batch_size=4, **BUCKETS, **extra)
    ours_ds = TTSDataset(script, HParams(**cfg))
    ref_ds = JaxTTSDataset(script, JaxHParams(**cfg))
    samples = [ours_ds[i] for i in range(3)]
    for i, s in enumerate(samples):
        r = ref_ds[i]
        for key in ("teacher_mel", "teacher_phone", "spk_emb_post"):
            np.testing.assert_allclose(s[key], r[key], rtol=1e-6,
                                       err_msg=key)
    ours = batching.collate(samples, HParams(**cfg), pad_batch=True)
    ref = jax_batching.collate(samples, JaxHParams(**cfg))
    for key in ("teacher_mel", "teacher_phone", "spk_emb_post", "mel"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    # the loader (the native mel reader, two threads) carries them
    batch = next(iter(DataLoader(ours_ds, HParams(**cfg), num_workers=2)))
    assert batch["teacher_mel"].shape == batch["mel"].shape
    assert batch["teacher_phone"].shape[:2] == batch["mel"].shape[:2]
    assert batch["spk_emb_post"].shape == (batch["mel"].shape[0], 12)


# ---- teacher forcing -------------------------------------------------------

@pytest.mark.parametrize("variance", ["target", "predicted"])
def test_teacher_forcing_cli_writes_jax_files(tmp_path, variance):
    from transformer_tts_tpu.cli import teacher_forcing as jax_tf_cli
    script, _ = _corpus(tmp_path, n=3, mel_dim=MEL)
    _, _, _, jax_dir, port_dir = teacher_dirs(tmp_path, script)
    flags = ["--suffix", "_tf", "--save_phone", "--variance", variance]
    jax_tf_cli.main(["--load_name", jax_dir, "--out_dir",
                     str(tmp_path / "jax_out"), *flags])
    tf_cli.main(["--load_name", port_dir, "--out_dir",
                 str(tmp_path / "port_out"), "--device", "cpu", *flags])
    names = sorted(os.listdir(tmp_path / "jax_out"))
    assert names == sorted(os.listdir(tmp_path / "port_out"))
    assert len(names) == 6 and "utt0_tf_phone.npy" in names
    for name in names:
        ref = np.load(tmp_path / "jax_out" / name)
        got = np.load(tmp_path / "port_out" / name)
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        # de-normalized by var up to 2: 1e-5 of max(1, max|ref|)
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()),
            err_msg=name)


# ---- the training CLI ------------------------------------------------------

def train_hp(tmp_path, script, name, **extra):
    cfg = dict(dict(SMALL_POST, batch_size=2, max_epoch=1, save_per_epoch=1,
                    train_script=script, save_dir=str(tmp_path / name),
                    num_workers=1, **BUCKETS), **extra)
    return write_hp(tmp_path / f"{name}.py", **cfg), cfg["save_dir"]


def steps_logged(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("epoch 1 step")]


def test_train_cli_mel_mel_routes_and_synthesis(tmp_path, capsys):
    script, _ = _corpus(tmp_path, n=4, mel_dim=MEL)
    _, _, _, _, port_dir = teacher_dirs(tmp_path, script)
    # the frozen teacher, a v3 student with the VQ
    hp_path, save_dir = train_hp(tmp_path, script, "melmel",
                                 architecture="mel-mel", version=3,
                                 phone_embed=True, vq_code=True,
                                 pretrain_model=port_dir)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "2"])
    out = capsys.readouterr().out
    assert "loaded the frozen teacher" in out and len(steps_logged(out)) == 2
    assert "loss_vq=" in out and "skipped_nan=0.0000" in out
    student_dir = os.path.join(save_dir, "epoch_1")
    state = torch.load(os.path.join(student_dir, "model.pt"))
    assert "quantize_lmfb.embed" in state and "linear2.weight" in state

    # the pregenerated route on teacher_forcing --save_phone's corpus
    tf_cli.main(["--load_name", port_dir, "--save_phone", "--device",
                 "cpu"])
    hp_path, save_dir = train_hp(tmp_path, script, "pregen",
                                 architecture="mel-mel", version=2,
                                 phone_embed=True, teacher_suffix="_gen")
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "2"])
    assert len(steps_logged(capsys.readouterr().out)) == 2

    # synthesize --post_model: the student of the first run refines the
    # teacher's mel as synthesize_fastspeech2_post does
    test_script = tmp_path / "test.txt"
    test_script.write_text("".join(open(script).readlines()[:2]))
    synth_cli.main(["--load_name", port_dir, "--test_script",
                    str(test_script), "--save", str(tmp_path / "post_out"),
                    "--max_frames", "64", "--device", "cpu",
                    "--post_model", student_dir])
    from transformer_tts_tpu_torch.infer.synthesize import load_post_model
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.models import build_model
    from transformer_tts_tpu_torch.train.checkpoint import load_checkpoint
    hp = load_hparams(os.path.join(port_dir, "hparams.py"))
    model = load_checkpoint(build_model(hp, device="cpu"), port_dir)
    student, p_hp = load_post_model(student_dir, hp, "cpu")
    assert p_hp.version == 3 and p_hp.vq_code
    from transformer_tts_tpu_torch.data.dataset import ScriptDataset
    from transformer_tts_tpu_torch.data.readers import Normalizer
    mean, var = (torch.from_numpy(a) for a in Normalizer(
        hp.mean_file, hp.var_file, MEL).arrays())
    for idx in range(2):
        sample = ScriptDataset(str(test_script), hp)[idx]
        batch = batching.collate([sample], hp)
        mel, mel_len, _ = synthesize_fastspeech2_post(
            model, student, torch.as_tensor(batch["text"]),
            torch.as_tensor(batch["pos_text"]), 64, mean, var,
            version=3, mel_dim_post=MEL)
        got = np.load(tmp_path / "post_out" / f"{idx}.npy")
        np.testing.assert_array_equal(got, mel[0, :int(mel_len[0])].numpy())


def test_train_cli_counts_nan_steps_and_aborts(tmp_path, capsys,
                                               monkeypatch):
    script, _ = _corpus(tmp_path, n=4, mel_dim=MEL)
    for line in open(script):
        name = line.split("|")[0]
        bad = np.load(name)
        bad[1, 0] = np.nan
        np.save(name.replace(".npy", "_gen.npy"), bad)
    hp_path, _ = train_hp(tmp_path, script, "nan", architecture="mel-mel",
                          version=1, teacher_suffix="_gen", max_epoch=3)
    monkeypatch.setattr(train_cli, "NAN_ABORT", 3)
    with pytest.raises(AssertionError, match="3 consecutive NaN steps"):
        train_cli.main(["--hp_file", hp_path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "skipped NaN step (1 total, 1 consecutive)" in out
    assert "skipped NaN step (2 total, 2 consecutive)" in out
    assert "skipped_nan=1.0000" in out


def test_train_cli_text_mel_mel_then_save_prenet(tmp_path, capsys):
    script, extra = _corpus(tmp_path, n=4, mel_dim=MEL, normalise=True)
    hp_path, save_dir = train_hp(
        tmp_path, script, "integrate", architecture="text-mel-mel",
        version=8, postnet_pred=False, phone_embed=True, semantic_mask=True,
        time_weight=(0.7, 0.3), **extra)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu",
                    "--max_steps", "2"])
    out = capsys.readouterr().out
    assert len(steps_logged(out)) == 2 and "replace_loss=" in out
    load_dir = os.path.join(save_dir, "epoch_1")
    state = torch.load(os.path.join(load_dir, "model.pt"))
    assert any(k.startswith("post_model_replace_mask.") for k in state)
    test_script = tmp_path / "test.txt"
    test_script.write_text("".join(open(script).readlines()[:2]))
    for flags, name in (([], "refined"), (["--save_prenet"], "prenet")):
        synth_cli.main(["--load_name", load_dir, "--test_script",
                        str(test_script), "--save", str(tmp_path / name),
                        "--max_frames", "64", "--device", "cpu", *flags])
    for idx in range(2):
        refined = np.load(tmp_path / "refined" / f"{idx}.npy")
        prenet = np.load(tmp_path / "refined" / f"{idx}_prenet.npy")
        saved = np.load(tmp_path / "prenet" / f"{idx}.npy")
        assert refined.shape == prenet.shape and refined.shape[1] == MEL
        np.testing.assert_array_equal(saved, prenet)
        assert not np.array_equal(refined, prenet)
        assert (tmp_path / "refined" / f"{idx}_alignment.npy").exists()


def test_train_cli_mel_mel_needs_a_teacher(tmp_path):
    script, _ = _corpus(tmp_path, n=2, mel_dim=MEL)
    hp_path, _ = train_hp(tmp_path, script, "none", architecture="mel-mel",
                          version=2)
    with pytest.raises(ValueError, match="pretrain_model"):
        train_cli.main(["--hp_file", hp_path, "--device", "cpu"])


# ---- the engines -----------------------------------------------------------

ENGINE_KW = dict(batch_size=2, frames_per_phone=4, text_buckets=(8, 16))


def student_dirs(tmp_path, **kw):
    """A mel-mel student (mel 16) in both packages' checkpoint formats,
    each beside its hparams."""
    cfg = dict(SMALL_POST, architecture="mel-mel", **BUCKETS, **kw)
    hp, _, variables, model = student_pair(2, **cfg)
    root = tmp_path / "student"
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        vq_stats=variables["vq_stats"], step=np.asarray(0, np.int32))
    jax_ckpt.save_checkpoint(jax_dir, state, 1, with_optimizer=False)
    save_checkpoint(model, port_dir)
    for d in (jax_dir, port_dir):
        write_hp(Path(d) / "hparams.py", **cfg)
    return hp, jax_dir, port_dir


TEXTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18, 1, 2, 3],
         [5, 6, 7]]


@pytest.mark.parametrize("version", [2, 3, 5])
def test_post_model_engine_matches_jax(tmp_path, version):
    from transformer_tts_tpu.infer.engine import TTSEngine as JaxEngine
    script, _ = _corpus(tmp_path, n=2, mel_dim=MEL)
    _, _, _, jax_dir, port_dir = teacher_dirs(tmp_path, script)
    _, s_jax, s_port = student_dirs(tmp_path, version=version,
                                    phone_embed=version != 5)
    ref = JaxEngine(jax_dir, post_model=s_jax, **ENGINE_KW).synthesize(TEXTS)
    engine = TTSEngine(port_dir, post_model=s_port, device="cpu",
                       **ENGINE_KW)
    got = engine.synthesize(TEXTS)
    for g, r in zip(got, ref):
        assert g["mel"].shape == r["mel"].shape
        np.testing.assert_allclose(
            g["mel"], r["mel"], rtol=0,
            atol=TOL * max(1.0, np.abs(r["mel"]).max()))
        np.testing.assert_array_equal(g["durations"], r["durations"])
    with pytest.raises(NotImplementedError, match="streaming"):
        next(engine.synthesize_streaming(TEXTS[0]))


def integrate_dirs(tmp_path, version=9):
    cfg = dict(SMALL_POST, mel_dim=8, mel_dim_post=8, architecture=(
        "text-mel-mel"), postnet_pred=False, phone_embed=True,
        version=version, **BUCKETS)
    hp, _, variables, model = integrate_pair(3, **{
        k: v for k, v in cfg.items()
        if k not in ("architecture", "postnet_pred", "phone_embed")})
    root = tmp_path / "integrate"
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        vq_stats=variables["vq_stats"], step=np.asarray(0, np.int32))
    jax_ckpt.save_checkpoint(jax_dir, state, 1, with_optimizer=False)
    save_checkpoint(model, port_dir)
    for d in (jax_dir, port_dir):
        write_hp(Path(d) / "hparams.py", **cfg)
    return hp, model, jax_dir, port_dir


def test_integrate_engine_matches_jax(tmp_path):
    from transformer_tts_tpu.infer.engine import TTSEngine as JaxEngine
    hp, model, jax_dir, port_dir = integrate_dirs(tmp_path)
    texts = [[t % 19 + 1 for t in x] for x in TEXTS]
    ref = JaxEngine(jax_dir, **ENGINE_KW).synthesize(texts)
    engine = TTSEngine(port_dir, device="cpu", **ENGINE_KW)
    got = engine.synthesize(texts)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(
            g["mel"], r["mel"], rtol=0,
            atol=TOL * max(1.0, np.abs(r["mel"]).max()))
        np.testing.assert_array_equal(g["durations"], r["durations"])
    # the refined mel, not the bare mel_pre
    text = torch.tensor([texts[0] + [0] * 3])
    pos = torch.tensor([list(range(1, 6)) + [0] * 3])
    refined, prenet, _, _ = synthesize_integrate(model, text, pos, 32)
    assert not torch.equal(refined, prenet)
    with pytest.raises(NotImplementedError, match="streaming"):
        next(engine.synthesize_streaming(texts[0]))
    with pytest.raises(ValueError, match="carry their post-model"):
        TTSEngine(port_dir, device="cpu", post_model=port_dir)


def test_post_and_integrate_exports_match_the_engine(tmp_path):
    script, _ = _corpus(tmp_path, n=2, mel_dim=MEL)
    _, _, _, _, port_dir = teacher_dirs(tmp_path, script)
    _, _, s_port = student_dirs(tmp_path, version=3, phone_embed=True)
    _, _, _, i_port = integrate_dirs(tmp_path, version=8)
    import transformer_tts_tpu_torch.ops.flash_attention  # noqa: F401
    kw = dict(ENGINE_KW, text_buckets=(8,))
    for name, engine in (
            ("fastspeech2_post", TTSEngine(port_dir, post_model=s_port,
                                           device="cpu", **kw)),
            ("integrate", TTSEngine(i_port, device="cpu", **kw))):
        out_dir = tmp_path / f"export_{name}"
        manifest = engine.export(str(out_dir))
        for bucket, entry in manifest["buckets"].items():
            assert entry["file"] == f"{name}_b2_l{bucket}.pt2"
            inputs = engine._padded([[1, 2, 3, 4], [5, 6]], 2, int(bucket))
            want = engine._run_padded(*inputs)
            program = torch.export.load(str(out_dir / entry["file"]))
            got = program.module()(*inputs)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, bucket)


def test_post_student_of_a_snapshot_without_hparams_uses_the_callers(
        tmp_path):
    from transformer_tts_tpu_torch.infer.synthesize import load_post_model
    hp = HParams(**dict(SMALL_POST, version=1))
    save_checkpoint(build_post_model(hp, device="cpu"), str(tmp_path))
    student, p_hp = load_post_model(str(tmp_path), hp, "cpu")
    assert p_hp is hp and not student.training
