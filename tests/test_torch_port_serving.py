"""The port's serving layer against the JAX package, on the CPU in fp32:
``TTSEngine``, the micro-batcher, the HTTP server and ``cli/serve.py``.

Small models (tests/torch_port_pair.engine_pair: d 32, 2+2 layers, every
dropout 0) written once as a JAX checkpoint by the JAX package's own
checkpoint code and once as a port checkpoint from ``state_dict_from_flax``;
each package's ``TTSEngine`` restores its own. The mel of every utterance
agrees at 1e-5 of max(1, max|ref|) (fp32 sums in other orders), durations
and lengths exactly, for the transformer and conformer FastSpeech 2, the AR
model (whose random rows stop at different steps) and GST with a
``ref_mel``. The batcher cases are ``tests/test_serving.py``'s, run against
the port's copy.
"""

import base64
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import wave
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from transformer_tts_tpu.infer.engine import TTSEngine as JaxTTSEngine
from transformer_tts_tpu_torch.cli import serve as serve_cli
from transformer_tts_tpu_torch.infer.engine import TTSEngine
from transformer_tts_tpu_torch.infer.server import (
    MicroBatcher, ServerFull, TTSServer, _result_to_json)

from torch_port_pair import (
    ENGINE, ENGINE_FAMILIES, ENGINE_TEXTS, SMALL, assert_results_match,
    engine_pair, write_tiny_vocoder)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ENGINE_TEXTS


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_engine_matches_jax_engine(family, tmp_path):
    jax_dir, port_dir, kw = engine_pair(family, tmp_path)
    ref = JaxTTSEngine(jax_dir, **ENGINE, **kw).synthesize(TEXTS)
    engine = TTSEngine(port_dir, **ENGINE, device="cpu", **kw)
    ours = engine.synthesize(TEXTS)
    assert_results_match(ours, ref)
    lengths = [r["mel"].shape[0] for r in ours]
    if family in ("ar", "gst"):
        assert all(r["durations"].shape == (0,) for r in ours)
        # some rows stop inside the budget and some run to it
        assert len(set(lengths)) > 2
        assert max(lengths) == engine.max_frames_for(16)
    else:
        assert [r["durations"].shape for r in ours] == [(len(t),)
                                                        for t in TEXTS]
        assert lengths == [int(r["durations"].sum()) for r in ours]
    assert set(engine.warmup()) == {8, 16}
    assert_results_match(engine.synthesize(TEXTS), ref)


def test_engine_results_name_the_bucket_their_batch_padded_to(tmp_path):
    _, port_dir, _ = engine_pair("transformer", tmp_path)
    engine = TTSEngine(port_dir, **ENGINE, device="cpu")
    # a batch pads to its longest text's bucket: 8 phones go to 16 beside 12
    assert [r["bucket"] for r in engine.synthesize(TEXTS)] == [8, 8, 16, 16,
                                                               16]
    assert engine.synthesize([TEXTS[3]])[0]["bucket"] == 8


def _write_hparams(root, **over):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "hparams.py"), "w") as fh:
        fh.write("".join(f"{k} = {v!r}\n"
                         for k, v in dict(SMALL, **over).items()))
    return str(root)


REFUSALS = {
    "tacotron2": (dict(model="Transformer", decoder_type="tacotron2"), {},
                  ValueError, "tacotron2"),
    "mel-mel": (dict(architecture="mel-mel"), {}, ValueError, "mel-mel"),
    "gst-without-ref_mel": (dict(model="Transformer", gst=True), {},
                            ValueError, "ref_mel"),
    "ref_mel-without-gst": ({}, dict(ref_mel="r.npy"), ValueError,
                            "gst is off"),
    "sq-vae": (dict(model="SQFastSpeech2"), {}, ValueError, "SQ-VAE"),
    # speakers are served (tests/test_torch_port_speakers_serving.py);
    # these two hparams name no table the model could build
    "multi-speaker": (dict(is_multi_speaker=True, num_speakers=4,
                           spk_emb_type="speaker_id",
                           spk_emb_architecture=("encoder",)), {},
                      ValueError, "spk_emb_dim"),
    "x-vector": (dict(is_multi_speaker=True, spk_emb_type="x_vector",
                      spk_emb_dim=16, spk_emb_architecture=("middle",)), {},
                 ValueError, "must be 512"),
    "text-mel-mel": (dict(architecture="text-mel-mel", version=3), {},
                     NotImplementedError, "mel-to-mel post-processing"),
    "post_model": ({}, dict(post_model="post"), NotImplementedError,
                   "mel-to-mel post-processing"),
    "int4": ({}, dict(quantize="int4"), ValueError, "only 'int8'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refuses_as_jax_or_by_later_slice(case, tmp_path):
    over, kw, error, match = REFUSALS[case]
    load_dir = _write_hparams(tmp_path / "ckpt", **over)
    with pytest.raises(error, match=match):
        TTSEngine(load_dir, device="cpu", **kw)


def test_the_card_is_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_dir, _ = engine_pair("transformer", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSEngine(port_dir, **ENGINE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--load_name", port_dir, "--port", "0"])


# ---- the micro-batcher (tests/test_serving.py's cases) ---------------------

def test_microbatcher_coalesces_and_preserves_order():
    calls = []

    def fake_synth(texts, speakers=None):
        calls.append([len(t) for t in texts])
        return [{"mel": np.zeros((len(t), 4), np.float32),
                 "durations": np.ones((len(t),), np.int32)} for t in texts]

    mb = MicroBatcher(fake_synth, batch_size=4, batch_window_ms=50.0)
    results = [None] * 6

    def worker(i):
        results[i] = mb.submit(list(range(1, i + 2)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    mb.close()
    for i, r in enumerate(results):
        assert r["mel"].shape == (i + 1, 4)   # each caller got its own
    assert 2 <= len(calls) <= 5               # coalesced
    assert sum(len(c) for c in calls) == 6


def test_microbatcher_propagates_errors():
    def bad_synth(texts, speakers=None):
        raise ValueError("boom")

    mb = MicroBatcher(bad_synth, batch_size=2, batch_window_ms=1.0)
    with pytest.raises(RuntimeError, match="boom"):
        mb.submit([1, 2, 3])
    mb.close()
    assert mb.n_errors == 1


def test_microbatcher_overload_rejects():
    gate = threading.Event()

    def slow_synth(texts, speakers=None):
        gate.wait(timeout=5)
        return [{"mel": np.zeros((1, 4), np.float32),
                 "durations": np.ones((1,), np.int32)} for _ in texts]

    mb = MicroBatcher(slow_synth, batch_size=1, batch_window_ms=1.0,
                      max_queue=2)
    results, errors = [], []

    def worker():
        try:
            results.append(mb.submit([1]))
        except ServerFull as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.02)          # a deterministic queue fill order
    gate.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    mb.close()
    assert len(errors) >= 1
    assert len(results) + len(errors) == 6
    assert mb.n_rejected == len(errors)
    assert mb.n_batches == len(results)


def test_result_to_json_wav_griffin_lim_on_the_given_device():
    rs = np.random.RandomState(0)
    r = {"mel": rs.randn(40, 8).astype(np.float32),
         "durations": np.ones(5, np.int32)}
    out = _result_to_json(r, wav=True, mel_dim=8, device="cpu")
    assert out["sample_rate"] == 22050 and out["mel_frames"] == 40
    with wave.open(io.BytesIO(base64.b64decode(out["wav_base64"]))) as fh:
        assert fh.getframerate() == 22050 and fh.getnchannels() == 1
        assert fh.getnframes() == 39 * 256       # Griffin-Lim's length


# ---- HTTP -------------------------------------------------------------------

def _request(port, method, path, body=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wav_samples(payload):
    with wave.open(io.BytesIO(base64.b64decode(payload["wav_base64"]))) as fh:
        return np.frombuffer(fh.readframes(fh.getnframes()), "<i2")


def test_http_round_trip(tmp_path):
    _, port_dir, _ = engine_pair("transformer", tmp_path)
    voc = write_tiny_vocoder(tmp_path / "voc")
    engine = TTSEngine(port_dir, **ENGINE, vocoder=voc, device="cpu")
    plain = TTSEngine(port_dir, **ENGINE, device="cpu")
    ref = engine.synthesize(TEXTS)
    servers = [TTSServer(e, port=0, batch_window_ms=1.0)
               for e in (engine, plain)]
    for s in servers:
        s.start()
    try:
        port = servers[0].port
        status, body = _request(port, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ok"]
        assert health["text_buckets"] == [8, 16] and health["batch_size"] == 2

        status, body = _request(port, "POST", "/synthesize",
                                {"text_ids": TEXTS[2], "wav": True})
        resp = json.loads(body)
        assert status == 200 and resp["mel_frames"] == len(resp["mel"])
        np.testing.assert_allclose(np.asarray(resp["mel"], np.float32),
                                   ref[2]["mel"], atol=1e-4)
        assert resp["durations"] == ref[2]["durations"].tolist()
        # the vocoder's audio, frames x hop samples
        np.testing.assert_allclose(
            _wav_samples(resp) / 32767.0, np.clip(ref[2]["audio"], -1, 1),
            atol=2e-4)

        status, body = _request(port, "POST", "/synthesize",
                                {"batch": TEXTS[:3]})
        resp = json.loads(body)
        assert status == 200 and len(resp["results"]) == 3
        assert [r["mel_frames"] for r in resp["results"]] == [
            r["mel"].shape[0] for r in ref[:3]]

        status, body = _request(port, "POST", "/synthesize_stream",
                                {"text_ids": TEXTS[2], "chunk_frames": 8})
        lines = [json.loads(ln) for ln in body.splitlines()]
        assert status == 200 and lines[-1]["done"]
        assert lines[-1]["mel_frames"] == ref[2]["mel"].shape[0]
        pcm = np.concatenate([
            np.frombuffer(base64.b64decode(ln["pcm16_base64"]), "<i2")
            for ln in lines[:-1]])
        np.testing.assert_allclose(pcm / 32767.0,
                                   np.clip(ref[2]["audio"], -1, 1),
                                   atol=2e-4)
        status, _ = _request(port, "POST", "/synthesize_stream", {})
        assert status == 400                   # fails before the stream
        status, _ = _request(port, "GET", "/nowhere")
        assert status == 404

        status, body = _request(port, "GET", "/metrics")
        metrics = json.loads(body)
        assert status == 200 and metrics["requests"] == 1
        assert metrics["batches"] == 1 and metrics["errors"] == 0

        # no vocoder: Griffin-Lim, (frames - 1) x hop samples
        status, body = _request(servers[1].port, "POST", "/synthesize",
                                {"text_ids": TEXTS[2], "wav": True})
        resp = json.loads(body)
        assert status == 200
        assert _wav_samples(resp).shape == (
            (ref[2]["mel"].shape[0] - 1) * 256,)
    finally:
        for s in servers:
            s.stop()


def test_http_overload_answers_503():
    gate = threading.Event()

    def slow_synth(texts, speakers=None):
        gate.wait(timeout=10)
        return [{"mel": np.zeros((1, 4), np.float32),
                 "durations": np.ones((1,), np.int32)} for _ in texts]

    engine = types.SimpleNamespace(
        synthesize=slow_synth, batch_size=1, text_buckets=(8,),
        hp=types.SimpleNamespace(model="Fastspeech2", mel_dim=4),
        device=torch.device("cpu"), lock=threading.RLock())
    server = TTSServer(engine, port=0, batch_window_ms=1.0, max_queue=1)
    server.start()
    statuses = []

    def client():
        statuses.append(_request(server.port, "POST", "/synthesize",
                                 {"text_ids": [1, 2]})[0])

    threads = [threading.Thread(target=client) for _ in range(6)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.05)
        gate.set()
        for t in threads:
            t.join(timeout=20)
            assert not t.is_alive()
    finally:
        server.stop()
    assert sorted(set(statuses)) == [200, 503]
    assert server.batcher.n_rejected == statuses.count(503)


def test_http_burst_gets_503_not_reset_connections():
    """40 clients at once while the engine is busy: each gets 200 or 503
    (socketserver's backlog of 5 would reset some connections)."""
    def synth(texts, speakers=None):
        with engine.lock:
            return [{"mel": np.zeros((1, 4), np.float32),
                     "durations": np.ones((1,), np.int32)} for _ in texts]

    engine = types.SimpleNamespace(
        synthesize=synth, batch_size=2, text_buckets=(8,),
        hp=types.SimpleNamespace(model="Fastspeech2", mel_dim=4),
        device=torch.device("cpu"), lock=threading.RLock())
    server = TTSServer(engine, port=0, batch_window_ms=1.0, max_queue=2)
    server.start()
    statuses, barrier = [], threading.Barrier(40)

    def client():
        barrier.wait()
        statuses.append(_request(server.port, "POST", "/synthesize",
                                 {"text_ids": [1]})[0])

    threads = [threading.Thread(target=client) for _ in range(40)]
    try:
        with engine.lock:
            for t in threads:
                t.start()
            deadline = time.time() + 30
            while len(statuses) < 40 - 2 - 2 and time.time() < deadline:
                time.sleep(0.01)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        server.stop()
    assert len(statuses) == 40 and set(statuses) == {200, 503}


def test_serve_cli_serves_then_stops_on_sigint(tmp_path):
    _, port_dir, _ = engine_pair("transformer", tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.serve",
         "--load_name", port_dir, "--port", "0", "--buckets", "8,16",
         "--batch_size", "2", "--frames_per_phone", "4", "--quantize",
         "int8", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = []
        for line in proc.stdout:
            out.append(line)
            if line.startswith("serving on"):
                break
        assert any(ln.startswith("int8 weights:") for ln in out), out
        port = int(out[-1].split()[2].rsplit(":", 1)[1])
        status, body = _request(port, "POST", "/synthesize",
                                {"text_ids": TEXTS[0]})
        assert status == 200 and json.loads(body)["mel_frames"] > 0
        status, body = _request(port, "GET", "/metrics")
        assert status == 200 and json.loads(body)["requests"] == 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
