"""The micro-batching HTTP synthesis server (the port of
transformer_tts_tpu/infer/server.py: ``MicroBatcher`` :46, ``ServerFull``,
``_result_to_json`` :138, ``TTSServer`` :176), stdlib only. Concurrent
requests are coalesced by a batcher thread into engine-sized batches (up
to ``batch_window_ms`` of gathering); past ``max_queue`` waiting requests a
request gets 503 at once.

API (JSON over HTTP), as the JAX server's:

* ``POST /synthesize`` body ``{"text_ids": [int, ...]}`` (through the
  batcher) or ``{"batch": [[int, ...], ...]}`` (one engine call), optional
  ``"speaker"``/``"speakers"`` and ``"wav": true``. Response ``{"mel":
  [[...]], "mel_frames": T, "durations": [...], "ms": wall}`` (a
  ``"results"`` list for a batch), with ``"wav_base64"`` and
  ``"sample_rate"`` for ``wav``: the engine's vocoder audio, or else
  Griffin-Lim on the engine's device under its lock.
* ``POST /synthesize_stream``: NDJSON lines, one per audio (``pcm16_base64``)
  or mel chunk, then ``{"done": true, "mel_frames": L, "ms": wall}``.
* ``GET /healthz``, ``GET /metrics`` (requests, errors, rejected, batches,
  mean batch size, mean latency, queue depth).

Unlike the JAX server, the listen backlog is 1024, not socketserver's 5,
so that a burst past it gets 503s and not reset connections.

The batcher takes any callable with ``TTSEngine.synthesize``'s signature.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import queue
import threading
import time
import wave as wave_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class _Pending:
    __slots__ = ("text", "speaker", "event", "result", "error")

    def __init__(self, text, speaker):
        self.text = text
        self.speaker = speaker
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class ServerFull(RuntimeError):
    """Queue at capacity: callers should answer 503."""


class MicroBatcher:
    """Coalesce concurrent single requests into batched synthesis calls.
    ``max_queue`` bounds admission: past it ``submit`` raises
    ``ServerFull`` at once rather than let latency grow without bound."""

    def __init__(self, synth_fn: Callable, batch_size: int,
                 batch_window_ms: float = 5.0,
                 max_queue: Optional[int] = None):
        self._synth = synth_fn
        self._batch = int(batch_size)
        self._window = batch_window_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=max_queue or 0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        # metrics, for monitoring: plain ints under the GIL
        self.n_requests = 0
        self.n_errors = 0
        self.n_rejected = 0
        self.n_batches = 0
        self.sum_batch_size = 0
        self.sum_wait_ms = 0.0

    def submit(self, text: Sequence[int], speaker=None) -> dict:
        p = _Pending(list(text), speaker)
        t0 = time.time()
        try:
            self._q.put_nowait(p)
        except queue.Full:
            self.n_rejected += 1
            raise ServerFull(
                f"queue at capacity ({self._q.maxsize})") from None
        self.n_requests += 1
        p.event.wait()
        self.sum_wait_ms += (time.time() - t0) * 1000
        if p.error is not None:
            self.n_errors += 1
            raise RuntimeError(p.error)
        return p.result

    def close(self):
        self._stop.set()
        try:
            self._q.put_nowait(None)   # wake the loop
        except queue.Full:
            pass                       # the loop sees _stop once it drains
        self._thread.join(timeout=5)

    def _loop(self):
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            group = [first]
            deadline = time.time() + self._window
            while len(group) < self._batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                group.append(nxt)
            try:
                speakers = None
                if any(p.speaker is not None for p in group):
                    speakers = [p.speaker for p in group]
                results = self._synth([p.text for p in group], speakers)
                self.n_batches += 1
                self.sum_batch_size += len(group)
                for p, r in zip(group, results):
                    p.result = r
                    p.event.set()
            except Exception as e:           # noqa: BLE001 — to the callers
                for p in group:
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()


def _result_to_json(r: dict, *, wav: bool = False, mel_dim: int = 80,
                    sample_rate: int = 22050, hop_length: int = 256,
                    device="cuda", lock=None) -> dict:
    """One engine result as the response's JSON fields; with ``wav`` a
    16-bit PCM WAV (base64) of ``r["audio"]``, or without one of
    Griffin-Lim on ``device``, ``lock`` held (the engine's)."""
    mel = r["mel"]
    out = {
        "mel": [[round(float(v), 5) for v in frame] for frame in mel],
        "mel_frames": int(mel.shape[0]),
        "durations": [int(d) for d in r["durations"]],
    }
    if wav and mel.shape[0] > 0:
        if "audio" in r:
            audio = np.asarray(r["audio"])
        else:
            from transformer_tts_tpu_torch.ops.melspectrogram import (
                griffin_lim_from_log_mel)
            with lock or contextlib.nullcontext(), torch.no_grad():
                audio = griffin_lim_from_log_mel(
                    torch.as_tensor(mel, dtype=torch.float32, device=device),
                    sample_rate=sample_rate, hop_length=hop_length,
                    n_mels=mel_dim).cpu().numpy()
        pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
        buf = io.BytesIO()
        with wave_mod.open(buf, "wb") as fh:
            fh.setnchannels(1)
            fh.setsampwidth(2)
            fh.setframerate(sample_rate)
            fh.writeframes(pcm.tobytes())
        out["wav_base64"] = base64.b64encode(buf.getvalue()).decode()
        out["sample_rate"] = sample_rate
    return out


class _HTTPServer(ThreadingHTTPServer):
    """A listen backlog of 1024 (socketserver's is 5): a burst of clients
    is admitted and answered, with 503 past ``max_queue``, where a short
    backlog would reset their connections."""
    request_queue_size = 1024


class TTSServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 batch_window_ms: float = 5.0,
                 max_queue: Optional[int] = 256):
        self.engine = engine
        self.batcher = MicroBatcher(engine.synthesize, engine.batch_size,
                                    batch_window_ms, max_queue=max_queue)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet by default
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self):
                """``POST /synthesize_stream``: JSON lines over a
                close-delimited HTTP/1.0 response, one per chunk as the
                engine makes it, then a ``done`` line. Body ``{"text_ids":
                [...]}`` and optional ``"speaker"``, ``"chunk_frames"``,
                ``"segment_steps"``. Streams bypass the batcher."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    kw = {}
                    if req.get("chunk_frames"):
                        kw["chunk_frames"] = int(req["chunk_frames"])
                    if req.get("segment_steps"):
                        kw["segment_steps"] = int(req["segment_steps"])
                    events = server.engine.synthesize_streaming(
                        req["text_ids"], req.get("speaker"), **kw)
                    first = next(events)   # fail before the headers
                except Exception as e:     # noqa: BLE001 — HTTP boundary
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                t0 = time.time()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()

                def line(ev):
                    if ev["type"] == "audio":
                        pcm = (np.clip(ev["pcm"], -1.0, 1.0)
                               * 32767).astype("<i2")
                        out = {"start_sample": int(ev["start_sample"]),
                               "pcm16_base64":
                                   base64.b64encode(pcm.tobytes()).decode()}
                    elif ev["type"] == "mel":
                        out = {"start_frame": int(ev["start_frame"]),
                               "mel": [[round(float(v), 5) for v in fr]
                                       for fr in ev["mel"]]}
                    else:
                        out = {"done": True,
                               "mel_frames": int(ev["mel_frames"]),
                               "ms": round((time.time() - t0) * 1000, 2)}
                    self.wfile.write((json.dumps(out) + "\n").encode())
                    self.wfile.flush()

                try:
                    line(first)
                    for ev in events:
                        line(ev)
                except (BrokenPipeError, ConnectionResetError):
                    pass                   # the client went away

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {
                        "ok": True,
                        "model": server.engine.hp.model,
                        "batch_size": server.engine.batch_size,
                        "text_buckets": list(server.engine.text_buckets),
                    })
                elif self.path == "/metrics":
                    b = server.batcher
                    n = max(b.n_requests, 1)
                    self._reply(200, {
                        "requests": b.n_requests,
                        "errors": b.n_errors,
                        "rejected": b.n_rejected,
                        "batches": b.n_batches,
                        "mean_batch_size": round(
                            b.sum_batch_size / max(b.n_batches, 1), 2),
                        "mean_latency_ms": round(b.sum_wait_ms / n, 2),
                        "queue_depth": b._q.qsize(),
                    })
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/synthesize_stream":
                    self._stream()
                    return
                if self.path != "/synthesize":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    t0 = time.time()
                    jopts = dict(wav=bool(req.get("wav")),
                                 mel_dim=server.engine.hp.mel_dim,
                                 device=server.engine.device,
                                 lock=server.engine.lock)
                    if "batch" in req:
                        results = server.engine.synthesize(
                            req["batch"], req.get("speakers"))
                        payload = {
                            "results": [_result_to_json(r, **jopts)
                                        for r in results],
                            "ms": round((time.time() - t0) * 1000, 2)}
                    else:
                        r = server.batcher.submit(req["text_ids"],
                                                  req.get("speaker"))
                        payload = _result_to_json(r, **jopts)
                        payload["ms"] = round((time.time() - t0) * 1000, 2)
                    self._reply(200, payload)
                except ServerFull as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:       # noqa: BLE001 — HTTP boundary
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self):
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)

    def serve_forever(self):
        self.httpd.serve_forever()
