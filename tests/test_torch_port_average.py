"""The port's checkpoint averaging and pruning (train/checkpoint.py,
cli/average_checkpoints.py) on the CPU: the averaged ``state_dict`` against
the float64 mean of the saved epochs' (BatchNorm statistics included,
``num_batches_tracked`` the newest epoch's), the directory it writes,
``--last N``, ``prune_checkpoints`` against the JAX package's on the same
epochs and policy, and the synthesis CLI on an ``average_`` directory.
"""

import os

import numpy as np
import pytest
import torch

from transformer_tts_tpu.train import checkpoint as jax_checkpoint
from transformer_tts_tpu_torch.cli import average_checkpoints as avg_cli
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.train import checkpoint

from torch_port_pair import CONFORMER, SMALL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the conformer model: BatchNorm in every conv module and the postnet
CFG = dict(SMALL, **CONFORMER)


def _save_epochs(save_dir, epochs, **extra):
    """One checkpoint per epoch, each with other random weights and
    BatchNorm statistics, ``num_batches_tracked`` 10 x epoch, ~3 frames
    per phone; the hparams beside them. Returns {epoch: state_dict}."""
    hp = HParams(**dict(CFG, **extra))
    states = {}
    for e in epochs:
        model = build_fastspeech2(hp, device="cpu", seed=e)
        with torch.no_grad():
            model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
                np.log(4.0))
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(generator=torch.Generator().manual_seed(e))
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0)
                elif name.endswith("num_batches_tracked"):
                    buf.fill_(10 * e)
        path = checkpoint.epoch_dir(save_dir, e)
        checkpoint.save_checkpoint(model, path)
        hp.snapshot(path)
        states[e] = {k: v.clone() for k, v in model.state_dict().items()}
    hp.snapshot(save_dir)
    return states


def _mean_of(states, epochs):
    out = {}
    for key, value in states[epochs[-1]].items():
        if value.is_floating_point():
            out[key] = (sum(states[e][key].double() for e in epochs)
                        / len(epochs)).float()
        else:
            out[key] = value
    return out


def _load(path):
    return torch.load(os.path.join(path, "model.pt"), weights_only=True)


def test_average_is_the_float64_mean(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    states = _save_epochs(save_dir, (1, 2, 3))
    avg, path = checkpoint.average_checkpoints(save_dir, 1, 3)
    assert path == os.path.join(save_dir, "average_epoch1-epoch3")
    assert sorted(os.listdir(path)) == ["hparams.py", "model.pt"]
    want = _mean_of(states, [1, 2, 3])
    saved = _load(path)
    assert sorted(saved) == sorted(want) == sorted(avg)
    n_stats = 0
    for key, value in want.items():
        assert saved[key].dtype == value.dtype, key
        assert torch.equal(saved[key], value), key
        n_stats += "running" in key
    assert n_stats > 0
    assert int(saved["postnet.pre_batchnorm.num_batches_tracked"]) == 30


def test_average_of_an_empty_range_raises(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    _save_epochs(save_dir, (1,))
    with pytest.raises(FileNotFoundError):
        checkpoint.average_checkpoints(save_dir, 2, 5)


@pytest.mark.parametrize("flags,epochs", [
    (["--last", "2"], [3, 4]),
    (["--start_epoch", "2", "--end_epoch", "3"], [2, 3]),
    ([], [1, 2, 3, 4])])
def test_average_cli(tmp_path, capsys, flags, epochs):
    save_dir = str(tmp_path / "ckpt")
    states = _save_epochs(save_dir, (1, 2, 3, 4))
    avg_cli.main(["--save_dir", save_dir, *flags])
    name = f"average_epoch{epochs[0]}-epoch{epochs[-1]}"
    assert name in capsys.readouterr().out
    saved = _load(os.path.join(save_dir, name))
    for key, value in _mean_of(states, epochs).items():
        assert torch.equal(saved[key], value), key


@pytest.mark.parametrize("current,max_epoch,save_per_epoch", [
    (30, 100, 15), (95, 100, 50), (25, 40, 30), (60, 200, 25)])
def test_prune_keeps_the_same_epochs_as_jax(tmp_path, current, max_epoch,
                                            save_per_epoch):
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(tmp_path / side)
        for e in range(1, current + 1):
            os.makedirs(os.path.join(dirs[side], f"epoch_{e}"))
    jax_checkpoint.prune_checkpoints(dirs["jax"], current, max_epoch,
                                     save_per_epoch)
    checkpoint.prune_checkpoints(dirs["port"], current, max_epoch,
                                 save_per_epoch)
    kept = checkpoint.list_epochs(dirs["port"])
    assert kept == jax_checkpoint.list_epochs(dirs["jax"])
    assert current in kept and len(kept) < current


def test_synthesis_cli_loads_an_average_dir(tmp_path):
    # the CLI on the average directory writes what it writes on a
    # directory holding the mean weights
    save_dir = str(tmp_path / "ckpt")
    script = tmp_path / "test.txt"
    script.write_text("a.npy|3 5 7 9 11\nb.npy|4 6 8\n")
    hp = HParams(**dict(CFG, test_script=str(script)))
    states = _save_epochs(save_dir, (1, 2), test_script=str(script))
    _, path = checkpoint.average_checkpoints(save_dir, 1, 2)
    assert checkpoint.resolve_checkpoint(path) == path
    manual = str(tmp_path / "manual")
    model = build_fastspeech2(hp, device="cpu")
    model.load_state_dict(_mean_of(states, [1, 2]))
    checkpoint.save_checkpoint(model, manual)
    hp.snapshot(manual)
    outs = []
    for load_name in (path, manual):
        out_dir = tmp_path / f"gen_{len(outs)}"
        synth_cli.main(["--load_name", load_name, "--save", str(out_dir),
                        "--max_frames", "64", "--device", "cpu"])
        outs.append([np.load(out_dir / f"{i}.npy") for i in range(2)])
    for got, want in zip(*outs):
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, want)
