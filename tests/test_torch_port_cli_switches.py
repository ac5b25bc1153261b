"""The port's training and synthesis CLIs' remaining switches, on the CPU.

On the corpus of tests/test_torch_port_train.py: ``debug_nans`` raises
``FloatingPointError`` naming the module whose output first goes
non-finite; ``profile_dir`` leaves a Chrome trace; the metrics JSONL and
the TensorBoard events appear, with image events under ``tb_images``; a
SIGTERM sent during step 2 stops the loop with a preemption checkpoint
that the synthesis CLI's ``--epoch`` then loads from ``save_dir``;
``--hp_file`` replaces the checkpoint's hparams; ``parse_hparams`` prints
a key.
"""

import glob
import json
import os
import signal

import numpy as np
import pytest
import torch

from test_torch_port_train import _corpus, _write_hp
from torch_port_pair import SMALL
from transformer_tts_tpu_torch.cli import parse_hparams as parse_cli
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.train import checkpoint
from transformer_tts_tpu_torch.train import trainer as trainer_module


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(hp_path, *extra):
    train_cli.main(["--hp_file", hp_path, "--device", "cpu", *extra])


def test_debug_nans_names_the_first_module_with_a_non_finite_output(
        tmp_path):
    script, _ = _corpus(tmp_path)
    cfg = dict(SMALL, text_buckets=(8, 16))
    model = build_fastspeech2(HParams(**cfg), device="cpu")
    name = next(k for k in model.state_dict()
                if k.startswith("decoder.") and k.endswith("q_linear.weight"))
    with torch.no_grad():
        model.state_dict()[name][0, 0] = float("nan")
    poisoned = str(tmp_path / "poisoned")
    checkpoint.save_checkpoint(model, poisoned)
    hp_path, _ = _write_hp(tmp_path, script, pretrain_model=poisoned,
                           debug_nans=True)
    module = name[:-len(".weight")]
    with pytest.raises(FloatingPointError, match=module.replace(".", r"\.")):
        _train(hp_path, "--max_steps", "1")
    assert not torch.is_anomaly_enabled()
    # the same run without the switch only finds out at the loss
    hp_path, _ = _write_hp(tmp_path, script, pretrain_model=poisoned)
    with pytest.raises(AssertionError, match="nan"):
        _train(hp_path, "--max_steps", "1")


def test_profile_dir_leaves_a_trace(tmp_path):
    script, _ = _corpus(tmp_path)
    prof_dir = tmp_path / "profile"
    hp_path, _ = _write_hp(tmp_path, script, profile_dir=str(prof_dir),
                           max_epoch=1)
    _train(hp_path, "--max_steps", "2")
    traces = glob.glob(str(prof_dir / "trace_*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_metrics_tensorboard_and_images(tmp_path):
    script, _ = _corpus(tmp_path)
    hp_path, save_dir = _write_hp(tmp_path, script, tb_images=True,
                                  save_attention_per_step=1, max_epoch=1)
    _train(hp_path, "--max_steps", "2")
    log_dir = os.path.join(save_dir, "logs")
    lines = [json.loads(x) for x in open(os.path.join(log_dir,
                                                      "train.jsonl"))]
    assert [x["step"] for x in lines] == [1, 2]
    for x in lines:
        assert np.isfinite(x["loss_total"]) and "steps_per_sec" in x
        assert "grad_norm" in x
    events = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert len(events) == 1
    raw = open(events[0], "rb").read()
    for tag in (b"loss_total", b"attention/encoder_l0_h0",
                b"attention/decoder_l0_h0", b"mel/predicted",
                b"mel/target"):
        assert tag in raw, tag
    assert raw.count(b"\x89PNG") == 2 * 4           # 4 images per step


def test_sigterm_stops_with_a_checkpoint_that_synthesis_loads(
        tmp_path, monkeypatch, capsys):
    script, _ = _corpus(tmp_path)         # 6 utterances: 3 batches of 2
    hp_path, save_dir = _write_hp(tmp_path, script, max_epoch=3,
                                  save_per_epoch=10 ** 6)
    real = trainer_module.make_fastspeech2_train_step
    handlers = []

    def signalling_step(hp, device):
        step = real(hp, device=device)

        def step_fn(state, batch):
            if state.step == 1:           # step 2 is running
                handler = signal.getsignal(signal.SIGTERM)
                handlers.append(handler)
                assert handler not in (signal.SIG_DFL, signal.SIG_IGN, None)
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch)
        return step_fn

    monkeypatch.setattr(trainer_module, "make_fastspeech2_train_step",
                        signalling_step)
    before = signal.getsignal(signal.SIGTERM)
    _train(hp_path)
    printed = capsys.readouterr().out
    assert len(handlers) == 1
    assert signal.getsignal(signal.SIGTERM) is before
    assert "epoch 1 step 2 " in printed and "step 3 " not in printed
    assert "preemption checkpoint saved at epoch 1 (step 2)" in printed
    assert checkpoint.list_epochs(save_dir) == [1]
    state = torch.load(os.path.join(save_dir, "epoch_1",
                                    checkpoint.TRAIN_STATE_NAME),
                       weights_only=False)
    assert state["step"] == 2 and "optimizer" in state
    # --epoch on save_dir: hparams from save_dir, weights from epoch_1
    assert os.path.exists(os.path.join(save_dir, "hparams.py"))
    out_dir = tmp_path / "gen"
    synth_cli.main(["--load_name", save_dir, "--epoch", "1",
                    "--test_script", script, "--save", str(out_dir),
                    "--max_frames", "64", "--device", "cpu"])
    assert len(glob.glob(str(out_dir / "*_alignment.npy"))) == 6


def _model_dir(tmp_path, name, script):
    cfg = dict(SMALL, text_buckets=(8, 16), test_script=script)
    path = tmp_path / name
    path.mkdir()
    (path / "hparams.py").write_text(
        "".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    checkpoint.save_checkpoint(build_fastspeech2(HParams(**cfg),
                                                 device="cpu"), str(path))
    return str(path)


def test_hp_file_replaces_the_checkpoints_hparams(tmp_path):
    three = tmp_path / "three.txt"
    three.write_text("a.npy|3 5 7 9\nb.npy|1 2 3\nc.npy|4\n")
    one = tmp_path / "one.txt"
    one.write_text("a.npy|3 5 7 9\n")
    load_dir = _model_dir(tmp_path, "model", str(three))
    other = tmp_path / "other.py"
    other.write_text(open(os.path.join(load_dir, "hparams.py")).read()
                     .replace(str(three), str(one)))
    for hp_file, n in ((None, 3), (str(other), 1)):
        out_dir = tmp_path / f"gen{n}"
        flags = ["--hp_file", hp_file] if hp_file else []
        synth_cli.main(["--load_name", load_dir, "--save", str(out_dir),
                        "--max_frames", "32", "--device", "cpu", *flags])
        assert len(glob.glob(str(out_dir / "*_alignment.npy"))) == n


def test_load_name_resolves_as_in_jax(tmp_path):
    save_dir = tmp_path / "run"
    for e in (1, 3):
        (save_dir / f"epoch_{e}").mkdir(parents=True)
    run = str(save_dir)
    assert checkpoint.resolve_checkpoint(run) == checkpoint.epoch_dir(run, 3)
    assert checkpoint.resolve_checkpoint(run, 1) == \
        checkpoint.epoch_dir(run, 1)
    epoch_1 = str(save_dir / "epoch_1")
    assert checkpoint.resolve_checkpoint(epoch_1) == epoch_1
    plain = str(tmp_path)
    assert checkpoint.resolve_checkpoint(plain) == plain


def test_parse_hparams_prints_a_key(tmp_path, capsys):
    hp_file = tmp_path / "h.py"
    hp_file.write_text("d_model_encoder = 48\n")
    parse_cli.main(["--hp_file", str(hp_file), "--key", "d_model_encoder"])
    assert capsys.readouterr().out.strip() == "48"
    parse_cli.main(["--hp_file", str(hp_file), "--key", "mel_dim"])
    assert capsys.readouterr().out.strip() == "80"
