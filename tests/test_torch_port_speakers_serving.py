"""The port's multi-speaker AR Transformer-TTS, its graphed decode with
speakers, the multi-speaker engine and the CLIs on a two-speaker corpus,
on the CPU in fp32.

The AR teacher-forced forward for ``spk_emb_vers`` 1 (per-layer speaker
biases) and 2 (``spk_proj`` of the L2-normalised speaker vector) against
JAX at 1e-4; the KV-cached decode with two speakers in one batch against
JAX's and each row alone; the CUDA graph's block schedule, emulated on
the CPU (a capture records the steps, a replay runs them again on the
graph's own tensors, as a CUDA graph replays fixed addresses), replayed
for a second speaker and equal to the eager loop of each, where a graph
that does not load the speakers misses the second call's; a stream with
a speaker; the engine (a mixed-speaker batch against solo calls, ``None``
as speaker 0, a wrong x-vector shape raising JAX's error, and against
JAX's engine); the train CLI then the synthesis CLI, each line in its own
voice.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.infer.engine import TTSEngine as JaxTTSEngine
from transformer_tts_tpu.infer.synthesize import (
    synthesize_transformer_tts as jax_synthesize)
from transformer_tts_tpu.ops.masks import create_masks as jax_create_masks
from transformer_tts_tpu_torch.cli import synthesize as synth_cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.config import load_hparams
from transformer_tts_tpu_torch.data.batching import collate
from transformer_tts_tpu_torch.data.dataset import ScriptDataset
from transformer_tts_tpu_torch.infer import synthesize as synth
from transformer_tts_tpu_torch.infer.engine import TTSEngine
from transformer_tts_tpu_torch.infer.streaming import ARStream
from transformer_tts_tpu_torch.infer.synthesize import (
    DecodeWeights, synthesize_fastspeech2, synthesize_transformer_tts)
from transformer_tts_tpu_torch.models import build_model
from transformer_tts_tpu_torch.ops.masks import create_masks, pad_mask
from transformer_tts_tpu_torch.train.checkpoint import (
    load_checkpoint, resolve_checkpoint)

from torch_port_pair import (
    AR, ENGINE, ENGINE_BUCKETS, ENGINE_TEXTS, SMALL, assert_results_match,
    build_ar_pair, build_pair, set_stop_bias, to_np,
    write_engine_checkpoints)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
N_SPEAKERS = 5
AR_IDS = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
              spk_emb_dim=N_SPEAKERS, spk_emb_architecture="encoder,decoder")
AR_VERS = {1: AR_IDS,
           2: dict(is_multi_speaker=True, spk_emb_type="x_vector",
                   spk_emb_dim=512, spk_emb_vers=2)}
NO_STOP = -30.0          # a stop bias at which no row stops


def _text(seed, b=2, l=10, lengths=(10, 7)):
    rs = np.random.RandomState(seed)
    text = np.zeros((b, l), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rs.randint(1, 40, n)
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    return text, pos


def _speaker_inputs(vers, b=2):
    if vers == 1:
        return np.array([1, 4][:b], np.int32)
    return np.random.RandomState(9).randn(b, 512).astype(np.float32)


def _torch_spk(spk):
    return (torch.as_tensor(spk) if spk.dtype == np.float32
            else torch.as_tensor(spk).long())


# ---- the AR model -----------------------------------------------------------

@pytest.mark.parametrize("vers", sorted(AR_VERS))
def test_ar_teacher_forced_forward_matches_jax(vers):
    hp, jmodel, variables, model = build_ar_pair(**AR_VERS[vers])
    text, pos_text = _text(3)
    t = 9
    trg = np.random.RandomState(4).randn(2, t, 16).astype(np.float32)
    pos_mel = np.where(np.arange(t)[None] < np.array([[t], [6]]),
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    spk = _speaker_inputs(vers)
    jmasks = jax_create_masks(jnp.asarray(pos_text), jnp.asarray(pos_mel),
                              model="transformer")
    ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(trg),
                       *jmasks, jnp.asarray(spk), train=False)
    masks = create_masks(torch.as_tensor(pos_text), torch.as_tensor(pos_mel),
                         model="transformer")
    with torch.no_grad():
        ours = model(torch.as_tensor(text).long(), torch.as_tensor(trg),
                     *masks, spk_emb=_torch_spk(spk))
    for name in ("mel_pre", "mel_post", "stop_token"):
        np.testing.assert_allclose(to_np(getattr(ours, name)),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    per_layer = [layer.spk_bias is not None for layer in model.decoder.layers]
    assert all(per_layer) == (vers == 1) and any(per_layer) == (vers == 1)
    assert (model.spk_proj is not None) == (vers == 2)


@pytest.fixture(scope="module")
def ar_pair():
    hp, jmodel, variables, model = build_ar_pair(**AR_IDS)
    set_stop_bias(variables, model, NO_STOP)
    return hp, jmodel, variables, model


def test_ar_decode_two_speakers_match_jax_and_each_row_alone(ar_pair):
    _, jmodel, variables, model = ar_pair
    steps = 12
    text, pos = _text(5, lengths=(10, 10))
    text[1] = text[0]                         # one text, two voices
    spk = np.array([1, 4], np.int32)
    jmel, jlen = jax_synthesize(jmodel, variables, jnp.asarray(text),
                                jnp.asarray(pos), jnp.asarray(spk),
                                max_steps=steps)
    tt, tp = torch.as_tensor(text).long(), torch.as_tensor(pos)
    mel, lengths = synthesize_transformer_tts(
        model, tt, tp, spk_emb=torch.as_tensor(spk).long(), max_steps=steps)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(to_np(mel), np.asarray(jmel), **TOL)
    assert (mel[0] - mel[1]).abs().max() > 1e-3      # the voices differ
    for row in range(2):
        solo, _ = synthesize_transformer_tts(
            model, tt[row:row + 1], tp[row:row + 1],
            spk_emb=torch.as_tensor(spk[row:row + 1]).long(),
            max_steps=steps)
        np.testing.assert_allclose(to_np(solo[0]), to_np(mel[row]),
                                   rtol=0, atol=1e-5)


class _FakeGraph:
    """A CUDA graph on the CPU: the capture records each decode step with
    the carry it ran on; a replay runs them again, reading and writing the
    same tensors, as a graph replays fixed addresses."""

    def __init__(self):
        self.steps = []

    def replay(self):
        for body, carry in self.steps:
            body(carry)

    def pool(self):
        return None


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture()
def fake_graphs(monkeypatch):
    capturing = []

    @contextlib.contextmanager
    def graph(g, pool=None):
        capturing.append(g)
        try:
            yield
        finally:
            capturing.pop()

    real_body = synth._ar_body

    def recording_body(*args, **kw):
        body = real_body(*args, **kw)

        def step(carry):
            if capturing:
                capturing[-1].steps.append((body, carry))
            return body(carry)
        return step

    monkeypatch.setattr(synth, "_ar_body", recording_body)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)


def _decode_inputs(model, text, pos, spk):
    src_mask = pad_mask(pos)
    spk = torch.as_tensor(spk).long()
    e_outputs, _ = model.encode(text, src_mask, None, spk)
    return (e_outputs, src_mask, model.precompute_cross_kv(e_outputs),
            model.speaker_biases(spk))


def _graphed_and_eager(model, steps, speakers, threshold=0.5):
    text, pos = _text(6, lengths=(10, 8))
    tt, tp = torch.as_tensor(text).long(), torch.as_tensor(pos)
    out = []
    with torch.inference_mode():
        graph = None
        for spk in speakers:
            e, mask, kv, biases = _decode_inputs(model, tt, tp, spk)
            if graph is None:
                graph = synth._ARGraph(model, e, mask, kv, steps, threshold,
                                       biases)
            carry = graph.decode(e, mask, kv, biases)
            got = carry["groups"].clone()
            ref = synth.ar_decode(model, e, mask, kv, steps, threshold,
                                  biases)["groups"]
            out.append((got, ref))
    return out


@pytest.mark.parametrize("steps,every", [(12, 4), (10, 3)])
def test_graph_schedule_replays_each_calls_speakers(ar_pair, fake_graphs,
                                                     monkeypatch, steps,
                                                     every):
    model = ar_pair[3]
    monkeypatch.setattr(synth, "DONE_CHECK_EVERY", every)
    (got1, ref1), (got2, ref2) = _graphed_and_eager(
        model, steps, [[1, 2], [4, 0]])
    assert torch.equal(got1, ref1) and torch.equal(got2, ref2)
    assert (ref1 - ref2).abs().max() > 1e-3


def test_a_graph_that_keeps_its_first_speakers_fails(ar_pair, fake_graphs,
                                                     monkeypatch):
    """The failure this guards against: speakers read as they were at the
    capture. A graph whose load leaves them out keeps the first call's
    speaker biases, and its second decode is not the eager loop's."""
    real_load = synth._ARGraph._load
    monkeypatch.setattr(
        synth._ARGraph, "_load",
        lambda self, e, m, kv, biases: real_load(self, e, m, kv,
                                                 self.spk_biases))
    (got1, ref1), (got2, ref2) = _graphed_and_eager(ar_pair[3], 12,
                                                    [[1, 2], [4, 0]])
    assert torch.equal(got1, ref1)
    assert (got2 - ref2).abs().max() > 1e-3


def test_ar_stream_with_a_speaker_equals_one_shot(ar_pair):
    model = ar_pair[3]
    text, pos = _text(7, b=1, lengths=(9,))
    tt, tp = torch.as_tensor(text).long(), torch.as_tensor(pos)
    spk = torch.tensor([3])
    ref, lengths = synthesize_transformer_tts(model, tt, tp, spk_emb=spk,
                                              max_steps=24)
    stream = ARStream(model, tt, tp, spk_emb=spk, max_steps=24,
                      segment_steps=8)
    chunks = [c for _, c in stream]
    got = torch.cat(chunks, dim=1)
    n = int(lengths[0])
    assert got.shape[1] == n and torch.equal(got[0], ref[0, :n])


def test_decode_weights_leave_out_the_speaker_bias(ar_pair):
    model = ar_pair[3]
    model.amp = True
    try:
        with torch.inference_mode():
            weights = DecodeWeights(model)
    finally:
        model.amp = False
    bias_modules = {id(m) for layer in model.decoder.layers
                    for m in layer.spk_bias.modules()}
    held = {id(m) for m, _, _ in weights.slots}
    assert held and not held & bias_modules
    assert id(model.decoder.layers[0].ff.f_1) in held


# ---- the engine -------------------------------------------------------------

FS2_IDS = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
               spk_emb_dim=N_SPEAKERS, spk_emb_architecture="encoder,decoder")
FS2_XVECTOR = dict(is_multi_speaker=True, spk_emb_type="x_vector",
                   spk_emb_dim=512,
                   spk_emb_architecture="encoder,middle,decoder",
                   use_hop=True)
FAMILIES = {"fs2-ids": (build_pair, FS2_IDS),
            "fs2-xvector": (build_pair, FS2_XVECTOR),
            "ar-ids": (build_ar_pair, AR_IDS)}


def _engine_dirs(family, root):
    os.makedirs(root, exist_ok=True)
    build, extra = FAMILIES[family]
    _, _, variables, model = build(**extra, **ENGINE_BUCKETS)
    cfg = dict(SMALL, **extra, **ENGINE_BUCKETS)
    if build is build_ar_pair:
        cfg.update(AR)
        set_stop_bias(variables, model, NO_STOP)
    return write_engine_checkpoints(root, cfg, variables, model,
                                   stats_seed=3)


def _voices(family, n):
    rs = np.random.RandomState(11)
    if family == "fs2-xvector":
        return [rs.randn(512).astype(np.float32) for _ in range(n)]
    return [int(x) for x in rs.randint(0, N_SPEAKERS, n)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mixed_speaker_batch_equals_solo_calls(family, tmp_path):
    _, port_dir = _engine_dirs(family, tmp_path)
    engine = TTSEngine(port_dir, **ENGINE, device="cpu")
    engine.warmup()
    texts = ENGINE_TEXTS[:4]
    voices = _voices(family, len(texts))
    results = engine.synthesize(texts, voices)
    for text, voice, res in zip(texts, voices, results):
        solo = engine.synthesize([text], [voice])[0]
        # a solo call pads to its own bucket: compare within one bucket
        if solo["bucket"] == res["bucket"]:
            np.testing.assert_allclose(solo["mel"], res["mel"], rtol=0,
                                       atol=1e-5 * max(
                                           1.0, np.abs(res["mel"]).max()))
    # two voices on one text differ; None is speaker 0 / the zero vector
    a, b = engine.synthesize([texts[0]] * 2, voices[:2])
    assert np.abs(a["mel"] - b["mel"]).max() > 1e-3
    zero = (np.zeros(512, np.float32) if family == "fs2-xvector" else 0)
    none, explicit = engine.synthesize([texts[0]] * 2, [None, zero])
    np.testing.assert_array_equal(none["mel"], explicit["mel"])
    assert np.array_equal(engine.synthesize([texts[0]])[0]["mel"],
                          none["mel"])
    # a stream carries its speaker: its mel equals the one-shot mel
    events = list(engine.synthesize_streaming(texts[0], voices[0]))
    mel = np.concatenate([e["mel"] for e in events if e["type"] == "mel"])
    one = engine.synthesize([texts[0]], [voices[0]])[0]["mel"]
    np.testing.assert_allclose(mel, one, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(one).max()))


def test_wrong_speakers_raise_jax_errors(tmp_path):
    _, port_dir = _engine_dirs("fs2-xvector", tmp_path / "x")
    engine = TTSEngine(port_dir, **ENGINE, device="cpu")
    with pytest.raises(ValueError, match="expects 512-d float speaker"):
        engine.synthesize([[1, 2, 3]], [np.zeros(16, np.float32)])
    _, port_dir = _engine_dirs("fs2-ids", tmp_path / "i")
    engine = TTSEngine(port_dir, **ENGINE, device="cpu")
    with pytest.raises(ValueError, match="expects integer speaker ids"):
        engine.synthesize([[1, 2, 3]], [np.zeros(4)])


def test_speaker_engine_matches_jax_engine(tmp_path):
    jax_dir, port_dir = _engine_dirs("fs2-ids", tmp_path)
    voices = _voices("fs2-ids", len(ENGINE_TEXTS))
    ref = JaxTTSEngine(jax_dir, **ENGINE).synthesize(ENGINE_TEXTS, voices)
    ours = TTSEngine(port_dir, **ENGINE, device="cpu").synthesize(
        ENGINE_TEXTS, voices)
    assert_results_match(ours, ref)


# ---- the CLIs ---------------------------------------------------------------

def _two_speaker_corpus(tmp_path, n=6, mel_dim=16):
    """Two speakers (column 2), mels named hop256/hop160 by turns, with
    alignment, f0 and energy siblings."""
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 12)
        t_mel = 3 * t_text
        base = tmp_path / f"utt{i}_{('hop256', 'hop160')[i % 2]}.npy"
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        np.save(str(base).replace(".npy", "_alignment.npy"),
                np.full((t_text,), 3, np.int32))
        np.save(str(base).replace(".npy", "_f0.npy"),
                (rs.rand(t_mel) * 300 + 60).astype(np.float32))
        np.save(str(base).replace(".npy", "_energy.npy"),
                (rs.rand(t_mel) * 100).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}|{(i // 2) % 2}")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "train.txt")


def test_train_cli_then_synthesis_cli_in_each_speakers_voice(tmp_path):
    script = _two_speaker_corpus(tmp_path)
    save_dir = str(tmp_path / "ckpt")
    cfg = dict(SMALL, batch_size=2, max_epoch=1, save_per_epoch=1,
               warmup_step=10, train_script=script, save_dir=save_dir,
               text_buckets=(8, 16), length_buckets=(32, 64),
               is_multi_speaker=True, spk_emb_type="speaker_id",
               spk_emb_dim=2, spk_emb_architecture="encoder,decoder",
               use_hop=True, CTC_training=True)
    hp_path = tmp_path / "hparams.py"
    hp_path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    train_cli.main(["--hp_file", str(hp_path), "--device", "cpu",
                    "--max_steps", "2"])
    load_dir = os.path.join(save_dir, "epoch_1")
    out_dir = tmp_path / "gen"
    synth_cli.main(["--load_name", load_dir, "--test_script", script,
                    "--save", str(out_dir), "--max_frames", "64",
                    "--device", "cpu"])
    hp = load_hparams(os.path.join(save_dir, "hparams.py"))
    model = build_model(hp, device="cpu")
    load_checkpoint(model, resolve_checkpoint(load_dir, None))
    data = ScriptDataset(script, hp)
    voices = []
    for idx in range(4):          # speakers 0, 0, 1, 1; hop 256, 160, ...
        batch = collate([data[idx]], hp)
        assert int(batch["spk_emb"][0]) == (idx // 2) % 2
        assert int(batch["hop_size"][0]) == 1 + idx % 2
        mel, mel_len, _ = synthesize_fastspeech2(
            model, *(torch.as_tensor(batch[k]) for k in ("text",
                                                         "pos_text")), 64,
            spk_emb=torch.as_tensor(batch["spk_emb"]),
            hop_size=torch.as_tensor(batch["hop_size"]))
        got = np.load(out_dir / f"{idx}.npy")
        np.testing.assert_allclose(got, to_np(mel[0, :int(mel_len[0])]),
                                   rtol=0, atol=1e-5)
        voices.append(got)
    # the same model in the other voice gives another mel
    batch = collate([data[0]], hp)
    other, _, _ = synthesize_fastspeech2(
        model, *(torch.as_tensor(batch[k]) for k in ("text", "pos_text")),
        64, spk_emb=torch.tensor([1]),
        hop_size=torch.as_tensor(batch["hop_size"]))
    assert np.abs(to_np(other[0, :len(voices[0])]) - voices[0]).max() > 1e-4
