"""The serving engine (the port of transformer_tts_tpu/infer/engine.py:
``TTSEngine``, :44-465): bucketed, warmed-up, batched synthesis.

* Requests are held to static text buckets (``text_buckets``, default
  ``hp.text_buckets``), each with one mel budget (``max_frames_for``:
  ``frames_per_phone`` per phone, rounded up to ``hp.length_buckets``), so
  the card sees a few shapes only.
* ``warmup()`` runs every (``batch_size``, bucket) shape once: the padded
  forward (FastSpeech 2), or the encoder and the decode's CUDA-graph
  capture (AR), and the vocoder at the bucket's budget; with
  ``streaming=True`` also one dummy stream per bucket. JAX compiles there;
  here the first call of a shape builds the graphs and cuDNN's plans.
* ``synthesize(texts)`` sorts by length, pads each group to
  ``batch_size`` rows, runs it, vocodes the padded batch and trims: one
  dict per utterance, ``mel`` (T, mel_dim) float32, ``durations`` (L,)
  int32 (empty for the AR model), ``audio`` (T * hop,) with a vocoder,
  and ``bucket``, the text bucket its batch was padded to (the longest
  text's in the batch; not a field of the JAX engine's results).
* ``synthesize_streaming(text, speaker)`` yields JAX's events: ``audio``
  (with a vocoder) or ``mel`` chunks, then ``end`` (infer/streaming.py).

Families: the transformer and conformer FastSpeech 2, the AR
Transformer-TTS, and GST with ``ref_mel`` (a (T, mel) ``.npy``, normalized
with the corpus statistics, styling every utterance); each of them
multi-speaker too. A multi-speaker model takes one speaker per request,
as JAX's engine does (its :94-100, :239-269): an int id for a speaker-id
model, a (``spk_emb_dim``,) float vector for an x-vector model; ``None``
(or no ``speakers``) means speaker 0 or the zero vector, and a wrong
shape raises JAX's error. Every call, warm-up included, passes a speaker
array, so a multi-speaker model runs one shape per bucket. A ``use_hop``
model is served at hop-size class 0 (JAX's engine passes no hop size).
The mel-to-mel line (JAX's :80-84, :148-166, :288-301): a text-mel-mel
snapshot serves its refined mel (``synthesize_integrate``), and
``post_model=`` (a mel-mel student's directory, built from its own
``hparams.py``) refines the FastSpeech 2 mel in the same call
(``synthesize_fastspeech2_post``); the student loads whole, its VQ
codebook included (JAX's engine restores its parameters only), and is
not quantized by ``quantize``, as in JAX's engine. Neither streams
(``NotImplementedError``: the refinement needs the whole mel). Refused
as JAX refuses them: the Tacotron 2 decoder, a bare mel-to-mel snapshot,
``post_model=`` with a text-mel-mel snapshot or an AR model, GST without
``ref_mel``; SQ-VAE hparams, as the port's synthesis CLI refuses them
(JAX's engine cannot restore them either).

``export(out_dir)`` writes ``torch.export`` artifacts, one per text
bucket and one per vocoder mel budget, and a ``manifest.json`` (see
``TTSEngine.export``).

One card, many threads: the HTTP server runs batch requests and streams on
its handler threads beside the micro-batcher's. The graph replays, the
kernels' launch counters and the vocoder's TF32 flags are process state,
and a CUDA graph capture fails if another thread launches work during it,
so every piece of device work holds ``lock``: a whole ``synthesize`` call,
each stream segment and vocoder window (released between a stream's
events, so a long utterance does not hold up the batcher), and the
server's Griffin-Lim fallback (infer/server._result_to_json).

``quantize="int8"`` is infer/quantize.py's weight-only int8, written into
the model's parameters before any graph is captured, so the AR decode's
bf16 weight copies (``DecodeWeights``) are taken from the dequantized
weights. It runs on the engine's ``device`` (default the CUDA card; it
raises when there is none).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from transformer_tts_tpu_torch.compat.from_jax import flax_layouts
from transformer_tts_tpu_torch.config import (
    is_nar_model, is_sq_model, load_hparams)
from transformer_tts_tpu_torch.data.batching import pick_bucket
from transformer_tts_tpu_torch.data.readers import Normalizer
from transformer_tts_tpu_torch.infer.quantize import quantize_parameters_
from transformer_tts_tpu_torch.infer.streaming import (
    ARStream, StreamingVocoder, vocode_pinned)
from transformer_tts_tpu_torch.infer.synthesize import (
    load_post_model, synthesize_fastspeech2, synthesize_fastspeech2_post,
    synthesize_integrate, synthesize_transformer_tts)
from transformer_tts_tpu_torch.models import build_model
from transformer_tts_tpu_torch.train.checkpoint import (
    load_checkpoint, resolve_checkpoint)


def _check_servable(hp, *, post_model, ref_mel) -> None:
    if not is_nar_model(hp.model) and hp.decoder_type.lower() == "tacotron2":
        raise ValueError(
            "TTSEngine serves the transformer families; the tacotron2 "
            "decoder stays on the offline CLI path (cli/synthesize)")
    if hp.architecture == "mel-mel":
        raise ValueError(
            "a bare mel-mel PostLowEnergy snapshot is not a text-to-speech "
            "model; serve its FastSpeech2 teacher with post_model=<this "
            "dir>, or use cli/synthesize --post_model")
    if hp.architecture == "text-mel-mel" and post_model is not None:
        raise ValueError(
            "text-mel-mel snapshots carry their post-model inside the joint "
            "checkpoint; drop post_model=")
    if post_model is not None and not is_nar_model(hp.model):
        raise ValueError(
            "post_model refines FastSpeech2 outputs; the AR families have "
            "their own causal postnet")
    if hp.gst and ref_mel is None:
        raise ValueError(
            "GST models need a style reference per session: pass "
            "ref_mel=<path to a reference mel .npy> "
            "(transformer.py:96-101 eval semantics)")
    if ref_mel is not None and not hp.gst:
        raise ValueError("ref_mel given but hp.gst is off")
    if is_sq_model(hp.model):
        raise ValueError(
            f"model={hp.model!r}: TTSEngine builds the plain FastSpeech 2 "
            "or the AR model, as the JAX engine does, and cannot restore an "
            "SQ-VAE FastSpeech 2 checkpoint; synthesize it with "
            "infer.synthesize.synthesize_fastspeech2 on "
            "models.fastspeech2_sq.build_sq_fastspeech2's model")


class TTSEngine:
    def __init__(self, load_dir: str, hp_file: Optional[str] = None, *,
                 epoch: Optional[int] = None, batch_size: int = 8,
                 frames_per_phone: int = 8,
                 text_buckets: Optional[Sequence[int]] = None,
                 vocoder: Optional[str] = None,
                 quantize: Optional[str] = None,
                 post_model: Optional[str] = None,
                 ref_mel: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda', but torch finds no CUDA device (pass "
                "device='cpu' to serve on the CPU)")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} unsupported (only "
                             "'int8')")
        name = os.path.basename(os.path.normpath(load_dir))
        hp_dir = (os.path.dirname(os.path.normpath(load_dir))
                  if name.startswith(("epoch_", "average_")) else load_dir)
        hp = load_hparams(hp_file or os.path.join(hp_dir, "hparams.py"))
        _check_servable(hp, post_model=post_model, ref_mel=ref_mel)
        self.hp = hp
        self.is_ar = not is_nar_model(hp.model)
        self.is_integrate = hp.architecture == "text-mel-mel"
        self.batch_size = int(batch_size)
        self.frames_per_phone = int(frames_per_phone)
        self.text_buckets = tuple(sorted(text_buckets or hp.text_buckets))
        self.lock = threading.RLock()
        # x-vector models take (spk_emb_dim,) floats, speaker-id models ids
        self.is_xvector = bool(
            hp.is_multi_speaker
            and (hp.spk_emb_type or "").lower() == "x_vector")
        self.spk_emb_dim = (int(hp.spk_emb_dim or 0) if self.is_xvector
                            else 0)

        self.model = build_model(hp, device=self.device)
        load_checkpoint(self.model, resolve_checkpoint(load_dir, epoch))
        self.model.eval()
        self.quantize = quantize
        self.quantize_stats = None
        if quantize is not None:
            self.quantize_stats = quantize_parameters_(self.model,
                                                       flax_layouts(hp))
        normalizer = Normalizer(hp.mean_file, hp.var_file, hp.mel_dim)
        mean, var = normalizer.arrays()
        self._mean = self._var = None
        if mean is not None:
            self._mean = torch.as_tensor(mean, dtype=torch.float32,
                                         device=self.device)
            self._var = torch.as_tensor(var, dtype=torch.float32,
                                        device=self.device)
        self._ref_mel = None
        if ref_mel is not None:
            ref = normalizer(np.load(ref_mel).astype(np.float32))
            self._ref_mel = torch.as_tensor(ref, dtype=torch.float32,
                                            device=self.device)[None]
        self._post = None
        if post_model is not None:
            self._post = load_post_model(post_model, hp, self.device)
        self._vocoder = None
        if vocoder is not None:
            from transformer_tts_tpu_torch.vocoder.trainer import (
                build_vocoder, restore_generator_params)
            gen = build_vocoder(hp, amp=False, device=self.device)
            gen.load_state_dict(restore_generator_params(vocoder,
                                                         self.device))
            self._vocoder = gen.eval()

    # ---------------- shapes ----------------

    def max_frames_for(self, text_bucket: int) -> int:
        return pick_bucket(text_bucket * self.frames_per_phone,
                           self.hp.length_buckets,
                           multiple=self.hp.reduction_rate or 1)

    def _bucket_of(self, n_phones: int) -> int:
        return pick_bucket(n_phones, self.text_buckets)

    def _padded(self, texts: List[Sequence[int]], rows: int, bucket: int):
        text = np.zeros((rows, bucket), np.int64)
        pos = np.zeros((rows, bucket), np.int64)
        for row, ids in enumerate(texts):
            text[row, :len(ids)] = ids
            pos[row, :len(ids)] = np.arange(1, len(ids) + 1)
        return (torch.as_tensor(text, device=self.device),
                torch.as_tensor(pos, device=self.device))

    def _speakers(self, idxs, speakers, rows: int) -> Optional[torch.Tensor]:
        """The (rows,) ids or (rows, spk_emb_dim) x-vectors of a padded
        batch whose row r holds request ``idxs[r]`` of ``speakers`` (None,
        None entries and pad rows: speaker 0 or the zero vector); None for
        a single-speaker model."""
        if not self.hp.is_multi_speaker:
            return None
        if self.is_xvector:
            spk = np.zeros((rows, self.spk_emb_dim), np.float32)
        else:
            spk = np.zeros((rows,), np.int64)
        for row, i in enumerate(idxs):
            s = speakers[i] if speakers is not None else None
            if s is None:
                continue
            if self.is_xvector:
                v = np.asarray(s, np.float32).reshape(-1)
                if v.shape != (self.spk_emb_dim,):
                    raise ValueError(
                        f"x-vector model expects {self.spk_emb_dim}-d "
                        f"float speaker embeddings, got shape {v.shape} "
                        f"for request {i}")
                spk[row] = v
            else:
                if np.ndim(s) != 0:
                    raise ValueError(
                        "speaker_id model expects integer speaker ids, "
                        f"got array-shaped value for request {i}")
                spk[row] = int(s)
        return torch.as_tensor(spk, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- run ----------------

    def warmup(self, streaming: bool = False) -> dict:
        """Run every (``batch_size``, bucket) shape once (and with
        ``streaming`` one dummy stream per bucket); {bucket: seconds}."""
        times = {}
        for b in self.text_buckets:
            t0 = time.perf_counter()
            with self.lock:
                self._run_padded(*self._padded([[1] * b] * self.batch_size,
                                               self.batch_size, b),
                                 self._speakers((), None, self.batch_size))
                if self._vocoder is not None:
                    vocode_pinned(self._vocoder, torch.zeros(
                        self.batch_size, self.max_frames_for(b),
                        self.hp.mel_dim, device=self.device))
                self._sync()
            if streaming:
                for _ in self.synthesize_streaming([1] * b, None):
                    pass
            times[b] = time.perf_counter() - t0
        return times

    def _run_padded(self, text: torch.Tensor, pos_text: torch.Tensor,
                    spk_emb: Optional[torch.Tensor] = None):
        """(mel (B, T, mel) de-normalized, mel_len (B,), durations (B, L)
        or None for the AR model) of one padded batch; ``lock`` held."""
        max_frames = self.max_frames_for(text.shape[1])
        if self.is_ar:
            mel, mel_len = _ar_synthesis(self.model, text, pos_text,
                                         spk_emb, max_frames, self._mean,
                                         self._var, self._ref_mel)
            return mel, mel_len, None
        return self._fastspeech2(text, pos_text, max_frames, spk_emb)

    def _fastspeech2(self, text, pos_text, max_frames: int, spk_emb):
        return _fastspeech2_synthesis(self.model, text, pos_text, spk_emb,
                                      max_frames, self._mean, self._var,
                                      self.is_integrate, self._post)

    def synthesize(self, texts: List[Sequence[int]],
                   speakers: Optional[Sequence] = None) -> List[dict]:
        """Synthesize token-id sequences; one dict per utterance (see the
        module docstring). ``speakers``, one per text, conditions a
        multi-speaker model (ids or x-vectors; None entries speaker 0 or
        the zero vector); a single-speaker model does not read it, as in
        JAX's engine."""
        out: List[Optional[dict]] = [None] * len(texts)
        order = sorted(range(len(texts)), key=lambda i: len(texts[i]))
        with self.lock:
            for lo in range(0, len(order), self.batch_size):
                idxs = order[lo:lo + self.batch_size]
                bucket = self._bucket_of(max(len(texts[i]) for i in idxs))
                spk = self._speakers(idxs, speakers, self.batch_size)
                mel, mel_len, durations = self._run_padded(*self._padded(
                    [texts[i] for i in idxs], self.batch_size, bucket), spk)
                audio = None
                if self._vocoder is not None:
                    audio = vocode_pinned(self._vocoder, mel).cpu().numpy()
                mel = mel.float().cpu().numpy()
                mel_len = mel_len.cpu().numpy()
                if durations is not None:
                    durations = durations.cpu().numpy()
                for row, i in enumerate(idxs):
                    n = int(mel_len[row])
                    out[i] = {"mel": mel[row, :n],
                              "durations": (durations[row, :len(texts[i])]
                                            if durations is not None
                                            else np.zeros((0,), np.int32)),
                              "bucket": bucket}
                    if audio is not None:
                        out[i]["audio"] = audio[
                            row, :n * self._vocoder.hop_length]
        return out  # type: ignore[return-value]

    # ---------------- streaming ----------------

    def synthesize_streaming(self, text, speaker=None, *,
                             chunk_frames: int = 64,
                             segment_steps: int = 32) -> Iterator[dict]:
        """Stream one utterance (batch 1, latency first). Events:
        ``{"type": "audio", "start_sample": s, "pcm": float32 (n,)}`` with a
        vocoder, the pcm concatenating to the one-shot ``synthesize``
        audio; else ``{"type": "mel", "start_frame": f, "mel": (t, mel)}``
        (AR: per decode segment, FastSpeech 2: one chunk); then ``{"type":
        "end", "mel_frames": L, "durations": (L_text,)}``. The AR model
        decodes ``segment_steps`` steps (a multiple of 8) per segment.
        ``speaker`` conditions a multi-speaker model, as in
        ``synthesize``."""
        if self.is_integrate or self._post is not None:
            raise NotImplementedError(
                "streaming does not run the mel-mel refinement stage (it "
                "needs the full mel); use synthesize() for post-processed "
                "models")
        spk = self._speakers([0], [speaker], 1)
        events = self._stream_events(list(text), spk, chunk_frames,
                                     segment_steps)
        while True:
            with self.lock:
                try:
                    event = next(events)
                except StopIteration:
                    return
            yield event

    def _stream_events(self, ids, spk, chunk_frames: int,
                       segment_steps: int):
        bucket = self._bucket_of(len(ids))
        text, pos = self._padded([ids], 1, bucket)
        max_frames = self.max_frames_for(bucket)
        sv = (StreamingVocoder(self._vocoder, chunk_frames=chunk_frames)
              if self._vocoder is not None else None)
        if not self.is_ar:
            mel, mel_len, durations = self._fastspeech2(text, pos,
                                                        max_frames, spk)
            n = int(mel_len[0])
            if sv is not None:
                for s, wav in sv.stream(mel[0], length=n):
                    yield {"type": "audio", "start_sample": s, "pcm": wav}
            else:
                yield {"type": "mel", "start_frame": 0,
                       "mel": mel[0, :n].float().cpu().numpy()}
            yield {"type": "end", "mel_frames": n,
                   "durations": durations[0, :len(ids)].cpu().numpy()}
            return

        stream = ARStream(
            self.model, text, pos, self._mean, self._var, spk_emb=spk,
            ref_mel=self._ref_mel,
            max_steps=max_frames // (self.hp.reduction_rate or 1),
            segment_steps=segment_steps)
        session = None
        if sv is not None and max_frames >= sv.window:
            session = sv.session(max_frames, batch=1,
                                 mel_dim=self.hp.mel_dim)
        chunks = [] if (sv is not None and session is None) else None
        for start_frame, mel_chunk in stream:
            if session is not None:
                for s, wav in session.feed(mel_chunk):
                    yield {"type": "audio", "start_sample": s,
                           "pcm": wav[0]}
            elif chunks is not None:
                chunks.append(mel_chunk)    # buffer too small to window
            else:
                yield {"type": "mel", "start_frame": start_frame,
                       "mel": mel_chunk[0].cpu().numpy()}
        n = int(stream.lengths[0])
        if session is not None:
            for s, wav in session.finish([n]):
                yield {"type": "audio", "start_sample": s, "pcm": wav[0]}
        elif chunks is not None:
            # the one-shot path's buffer, zero past the length: a shorter
            # one would pad the convolutions' outputs, not their inputs
            mel = torch.cat(chunks, dim=1)[0]
            buf = mel.new_zeros(max_frames, mel.shape[1])
            buf[:mel.shape[0]] = mel
            for s, wav in sv.stream(buf, length=n):
                yield {"type": "audio", "start_sample": s, "pcm": wav}
        yield {"type": "end", "mel_frames": n,
               "durations": np.zeros((0,), np.int32)}

    # ---------------- export ----------------

    def export(self, out_dir: str) -> dict:
        """Serialize one ``torch.export`` artifact per text bucket, and with
        a vocoder one per mel budget; returns the manifest (also written as
        ``manifest.json``), with the JAX engine's keys.

        ``{stem}_b{B}_l{bucket}.pt2`` (stem ``fastspeech2``,
        ``transformer_tts``, ``integrate`` for a text-mel-mel snapshot or
        ``fastspeech2_post`` with a mel-to-mel student, whose weights are
        baked in too) takes ``(text, pos_text)`` (B, bucket) int64
        and, for a multi-speaker model, ``spk`` ((B,) int64 ids or (B,
        spk_emb_dim) float32 x-vectors), and returns ``_run_padded``'s
        outputs: (mel, mel_len, durations), the AR model's (mel, mel_len).
        The weights are baked in (an int8 engine's dequantized ones, as it
        serves them), so are the corpus statistics and a GST engine's
        ``ref_mel``. The AR artifact holds the whole decode as one
        ``torch.while_loop`` (``infer.synthesize.ar_decode_loop``), which
        stops where JAX's does. ``vocoder_b{B}_f{budget}.pt2`` maps a (B,
        budget, mel_dim) float32 mel to its (B, budget * hop) waveform; the
        engine vocodes with TF32 off (``vocode_pinned``), a global switch
        that an artifact cannot hold, so the manifest's
        ``vocoder.allow_tf32`` (false) says how to call it.

        A loader needs ``torch.export.load(path).module()`` after
        importing ``transformer_tts_tpu_torch.ops.flash_attention`` and
        ``transformer_tts_tpu_torch.ops.flash_relpos``, which register the
        kernels' ``tts_port`` ops. ``platforms`` names the device the
        artifact was exported on and runs on.
        """
        os.makedirs(out_dir, exist_ok=True)
        manifest = {"model": self.hp.model, "mel_dim": self.hp.mel_dim,
                    "batch_size": self.batch_size, "buckets": {},
                    "speaker_input": (
                        None if not self.hp.is_multi_speaker else
                        ("x_vector" if self.is_xvector else "speaker_id"))}
        stem = ("transformer_tts" if self.is_ar else "integrate"
                if self.is_integrate else "fastspeech2_post"
                if self._post is not None else "fastspeech2")
        platforms = [self.device.type]
        with self.lock:
            for bucket in self.text_buckets:
                max_frames = self.max_frames_for(bucket)
                inputs = self._padded([], self.batch_size, bucket)
                spk = self._speakers((), None, self.batch_size)
                if spk is not None:
                    inputs = (*inputs, spk)
                name = f"{stem}_b{self.batch_size}_l{bucket}.pt2"
                _save(SynthesisProgram(self, max_frames), inputs,
                      os.path.join(out_dir, name))
                manifest["buckets"][str(bucket)] = {
                    "file": name, "max_frames": max_frames,
                    "platforms": platforms}
            if self._vocoder is not None:
                budgets = sorted({self.max_frames_for(b)
                                  for b in self.text_buckets})
                manifest["vocoder"] = {
                    "hop_length": self._vocoder.hop_length, "budgets": {},
                    "allow_tf32": False}
                for mf in budgets:
                    name = f"vocoder_b{self.batch_size}_f{mf}.pt2"
                    mel = torch.zeros(self.batch_size, mf, self.hp.mel_dim,
                                      device=self.device)
                    _save(VocoderProgram(self._vocoder), (mel,),
                          os.path.join(out_dir, name))
                    manifest["vocoder"]["budgets"][str(mf)] = {
                        "file": name, "platforms": platforms}
        with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=2)
        return manifest


def _fastspeech2_synthesis(model, text, pos_text, spk_emb, max_frames: int,
                           mean, var, integrate: bool = False, post=None):
    """``synthesize_fastspeech2`` as the engine runs it, or
    ``synthesize_integrate`` (``integrate``) or
    ``synthesize_fastspeech2_post`` (``post``: the student and its
    hparams): (mel, mel_len, durations). A ``use_hop`` model gets hop-size
    class 0 (the data layer's class of a mel named neither hop256 nor
    hop160: JAX's engine passes none and cannot serve such a model)."""
    hop = (torch.zeros(text.shape[0], dtype=torch.long, device=text.device)
           if model.hop_emb is not None else None)
    if integrate:
        refined, _, mel_len, durations = synthesize_integrate(
            model, text, pos_text, max_frames, mean, var, spk_emb=spk_emb,
            hop_size=hop)
        return refined, mel_len, durations
    if post is not None:
        student, p_hp = post
        return synthesize_fastspeech2_post(
            model, student, text, pos_text, max_frames, mean, var,
            version=p_hp.version, mel_dim_post=p_hp.mel_dim_post,
            spk_emb=spk_emb, hop_size=hop)
    return synthesize_fastspeech2(model, text, pos_text, max_frames, mean,
                                  var, spk_emb=spk_emb, hop_size=hop)


def _ar_synthesis(model, text, pos_text, spk_emb, max_frames: int, mean,
                  var, ref_mel, loop: bool = False):
    """``synthesize_transformer_tts`` as the engine runs it: ``max_frames``
    // r decode steps; with ``loop`` as one ``torch.while_loop``."""
    return synthesize_transformer_tts(
        model, text, pos_text, mean, var, spk_emb=spk_emb, ref_mel=ref_mel,
        max_steps=max_frames // model.reduction_rate, loop=loop)


class SynthesisProgram(nn.Module):
    """What one bucket's artifact runs: the engine's ``_run_padded`` at
    ``max_frames``, its model, corpus statistics and style reference held
    as this module's own, the AR decode as one ``torch.while_loop``."""

    def __init__(self, engine: TTSEngine, max_frames: int):
        super().__init__()
        self.model = engine.model
        self.is_ar = engine.is_ar
        self.is_integrate = engine.is_integrate
        self.student = None if engine._post is None else engine._post[0]
        self.post_hp = None if engine._post is None else engine._post[1]
        self.max_frames = max_frames
        self.register_buffer("mean", engine._mean)
        self.register_buffer("var", engine._var)
        self.register_buffer("ref_mel", engine._ref_mel)

    def forward(self, text, pos_text, spk=None):
        if self.is_ar:
            return _ar_synthesis(self.model, text, pos_text, spk,
                                 self.max_frames, self.mean, self.var,
                                 self.ref_mel, loop=True)
        post = (None if self.student is None
                else (self.student, self.post_hp))
        return _fastspeech2_synthesis(self.model, text, pos_text, spk,
                                      self.max_frames, self.mean, self.var,
                                      self.is_integrate, post)


class VocoderProgram(nn.Module):
    """What a vocoder artifact runs: the generator on an fp32 mel."""

    def __init__(self, vocoder: nn.Module):
        super().__init__()
        self.vocoder = vocoder

    def forward(self, mel):
        return self.vocoder(mel.float())


def _save(program: nn.Module, inputs: tuple, path: str) -> None:
    with torch.no_grad():
        exported = torch.export.export(program.eval(), tuple(inputs))
    torch.export.save(exported, path)
