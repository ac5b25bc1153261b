"""The port's streaming synthesis (infer/streaming.py) on the CPU in fp32:
streamed output equals one-shot output.

* ``receptive_field_frames`` equals the JAX package's for the same vocoder
  configs (HiFi-GAN subpixel and transposed, V1, the iSTFT vocoder).
* ``StreamingVocoder.stream`` and ``VocoderSession`` against the one-shot
  vocode of the same buffer at 1e-5, for HiFi-GAN and the iSTFT vocoder.
* ``ARStream`` against the port's one-shot ``synthesize_transformer_tts``
  and the JAX package's ``ARStream`` on the same weights
  (tests/torch_port_pair.build_ar_pair) at 1e-5 of max(1, max|ref|), chunk
  for chunk; two interleaved streams each equal their own one-shot output.
* ``TTSEngine.synthesize_streaming``: the pcm equals ``synthesize``'s audio
  (FastSpeech 2; the AR model windowed and on one buffer), the AR mel
  events its mel, with no frame at or past the length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.infer.streaming import (
    ARStream as JaxARStream, receptive_field_frames as jax_rf)
from transformer_tts_tpu.vocoder.generator import (
    HiFiGANGenerator as JaxHiFiGAN, ISTFTVocoder as JaxISTFT)
from transformer_tts_tpu_torch.infer.engine import TTSEngine
from transformer_tts_tpu_torch.infer.streaming import (
    ARStream, StreamingVocoder, receptive_field_frames, vocode_pinned)
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_transformer_tts)
from transformer_tts_tpu_torch.vocoder.generator import (
    HiFiGANGenerator, ISTFTVocoder, init_vocoder_parameters)

from torch_port_pair import (
    AR_STOP_BIAS, ENGINE, build_ar_pair, engine_pair, set_stop_bias,
    write_tiny_vocoder)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEL_DIM = 8
TINY = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),))
TINY_ISTFT = dict(channels=16, mlp_dim=32, num_layers=2, n_fft=16,
                  hop_length=8)
VOCODERS = {
    "subpixel": (HiFiGANGenerator, JaxHiFiGAN, dict(TINY,
                                                    upsample_mode="subpixel")),
    "transposed": (HiFiGANGenerator, JaxHiFiGAN,
                   dict(TINY, upsample_mode="transposed")),
    "v1": (HiFiGANGenerator, JaxHiFiGAN, {}),
    "istft": (ISTFTVocoder, JaxISTFT, TINY_ISTFT),
    "istft-default": (ISTFTVocoder, JaxISTFT, {}),
}


def _vocoder(kind, seed=0):
    cls, _, kw = VOCODERS[kind]
    gen = cls(mel_dim=MEL_DIM, **kw)
    with torch.no_grad():
        init_vocoder_parameters(gen, torch.Generator().manual_seed(seed))
    return gen.eval()


def _mel(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _oneshot(gen, mel):
    return vocode_pinned(gen, torch.as_tensor(mel)).numpy()


@pytest.mark.parametrize("kind", sorted(VOCODERS))
def test_receptive_field_equals_jax(kind):
    cls, jcls, kw = VOCODERS[kind]
    assert receptive_field_frames(cls(mel_dim=MEL_DIM, **kw)) == jax_rf(
        jcls(mel_dim=MEL_DIM, **kw))


@pytest.mark.parametrize("kind", ["subpixel", "transposed", "istft"])
@pytest.mark.parametrize("length", [96, 57])
def test_streaming_vocoder_equals_oneshot(kind, length):
    gen = _vocoder(kind)
    mel = _mel(1, 2, 96, MEL_DIM)
    full = _oneshot(gen, mel)
    sv = StreamingVocoder(gen, chunk_frames=16)
    assert sv.window < mel.shape[1]          # real windows
    chunks = list(sv.stream(mel, length=length))
    assert len(chunks) > 1
    starts = [s for s, _ in chunks]
    sizes = [w.shape[1] for _, w in chunks]
    assert starts == [0] + list(np.cumsum(sizes)[:-1])
    got = np.concatenate([w for _, w in chunks], axis=1)
    np.testing.assert_allclose(got, full[:, :length * gen.hop_length],
                               atol=1e-5, rtol=1e-5)


def test_streaming_vocoder_small_buffer_is_one_call():
    gen = _vocoder("subpixel")
    mel = _mel(2, 12, MEL_DIM)                  # (T, mel): one utterance
    sv = StreamingVocoder(gen, chunk_frames=16)
    chunks = list(sv.stream(mel, length=10))
    assert len(chunks) == 1 and chunks[0][1].ndim == 1
    np.testing.assert_allclose(chunks[0][1],
                               _oneshot(gen, mel[None])[0, :10 * 8],
                               atol=1e-6)


def test_streaming_vocoder_rejects_a_small_overlap():
    with pytest.raises(ValueError, match="receptive field"):
        StreamingVocoder(_vocoder("subpixel"), overlap_frames=2)


@pytest.mark.parametrize("kind", ["subpixel", "istft"])
def test_vocoder_session_equals_oneshot(kind):
    """Masked decode chunks of odd sizes, then ``finish`` with the rows'
    lengths: the one-shot vocode of the masked buffer."""
    gen = _vocoder(kind)
    total, lengths = 96, [61, 71]
    masked = _mel(3, 2, total, MEL_DIM)
    for b, ln in enumerate(lengths):
        masked[b, ln:] = 0.0
    full = _oneshot(gen, masked)
    sess = StreamingVocoder(gen, chunk_frames=16).session(total, batch=2)
    got, early, fed = [], 0, 0
    for step in [7, 11, 13, 25, 19]:
        out = sess.feed(masked[:, fed:fed + step])
        fed += step
        early += len(out)
        got.extend(out)
    assert early > 0                           # audio before the finish
    got.extend(sess.finish(lengths))
    wav = np.concatenate([w for _, w in got], axis=1)
    n = max(lengths) * gen.hop_length
    assert wav.shape[1] == n
    np.testing.assert_allclose(wav, full[:, :n], atol=1e-5, rtol=1e-5)


def test_vocoder_session_full_feed_and_guards():
    gen = _vocoder("subpixel")
    mel = _mel(5, 1, 64, MEL_DIM)
    sv = StreamingVocoder(gen, chunk_frames=16)
    sess = sv.session(64, batch=1)
    got = sess.feed(mel)
    assert sess.finish([64]) == []
    np.testing.assert_allclose(np.concatenate([w for _, w in got], axis=1),
                               _oneshot(gen, mel), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="total_frames"):
        sv.session(sv.window - 1)
    with pytest.raises(ValueError, match="past the session buffer"):
        sv.session(sv.window).feed(np.zeros((1, sv.window + 1, MEL_DIM)))


# ---- the AR decode ----------------------------------------------------------

@pytest.fixture(scope="module")
def ar_pair():
    hp, jmodel, variables, model = build_ar_pair()
    set_stop_bias(variables, model, AR_STOP_BIAS)
    return hp, jmodel, variables, model


def _ar_inputs(seed, b=2, l=10):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 30, (b, l)).astype(np.int32)
    pos = np.tile(np.arange(1, l + 1, dtype=np.int32)[None], (b, 1))
    mean = rs.randn(16).astype(np.float32)
    var = (rs.rand(16) + 0.5).astype(np.float32)
    return text, pos, mean, var


def _tol(ref):
    return dict(rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


# (rows, stop threshold): 2.0 never stops, so every segment runs; at 0.52
# one row stops in the first segment and one runs to the end; at 0.54 the
# one row stops in the fourth segment, which the graph blocks overrun
AR_STREAM_CASES = [(2, 2.0), (2, 0.52), (1, 0.54)]


@pytest.mark.parametrize("rows,stop_threshold", AR_STREAM_CASES)
def test_ar_stream_equals_oneshot_and_jax(ar_pair, rows, stop_threshold):
    _, jmodel, variables, model = ar_pair
    text, pos, mean, var = _ar_inputs(5, b=rows)
    max_steps, seg = 32, 8
    t = [torch.as_tensor(x) for x in (text, pos, mean, var)]
    ref, ref_len = synthesize_transformer_tts(
        model, t[0], t[1], t[2], t[3], max_steps=max_steps,
        stop_threshold=stop_threshold)
    ref, ref_len = ref.numpy(), ref_len.numpy()
    stream = ARStream(model, *t, max_steps=max_steps, segment_steps=seg,
                      stop_threshold=stop_threshold)
    chunks = [(s, c.numpy()) for s, c in stream]
    np.testing.assert_array_equal(stream.lengths, ref_len)
    got = np.concatenate([c for _, c in chunks], axis=1)
    assert got.shape[1] == ref_len.max()       # nothing past the longest
    starts = [s for s, _ in chunks]
    assert starts == [0] + list(np.cumsum([c.shape[1]
                                           for _, c in chunks])[:-1])
    np.testing.assert_allclose(got, ref[:, :got.shape[1]], **_tol(ref))
    assert not ref[:, got.shape[1]:].any()
    if stop_threshold > 1.0:
        assert len(chunks) == max_steps // seg
    else:
        assert ref_len.min() < max_steps * 2     # a row stops
    jstream = JaxARStream(jmodel, variables, jnp.asarray(text),
                          jnp.asarray(pos), mean=jnp.asarray(mean),
                          var=jnp.asarray(var), max_steps=max_steps,
                          segment_steps=seg, stop_threshold=stop_threshold)
    jchunks = list(jstream)
    np.testing.assert_array_equal(jstream.lengths, stream.lengths)
    assert [s for s, _ in jchunks] == starts
    for (_, c), (_, jc) in zip(chunks, jchunks):
        np.testing.assert_allclose(c, np.asarray(jc), **_tol(jc))


def test_interleaved_ar_streams_each_equal_their_oneshot(ar_pair):
    model = ar_pair[3]
    streams, refs = [], []
    for seed in (6, 7):
        text, pos, mean, var = (torch.as_tensor(x)
                                for x in _ar_inputs(seed, b=1))
        refs.append(synthesize_transformer_tts(
            model, text, pos, mean, var, max_steps=32, stop_threshold=2.0))
        streams.append(iter(ARStream(model, text, pos, mean, var,
                                     max_steps=32, segment_steps=8,
                                     stop_threshold=2.0)))
    got = [[], []]
    for _ in range(4):                          # one segment each in turn
        for i in (0, 1):
            got[i].append(next(streams[i])[1])
    for i in (0, 1):
        with pytest.raises(StopIteration):
            next(streams[i])
        mel = torch.cat(got[i], dim=1).numpy()
        np.testing.assert_allclose(mel, refs[i][0].numpy(),
                                   **_tol(refs[i][0].numpy()))


def test_segment_steps_must_be_a_multiple_of_the_block(ar_pair):
    text, pos, _, _ = (torch.as_tensor(x) for x in _ar_inputs(8))
    with pytest.raises(ValueError, match="multiple of DONE_CHECK_EVERY"):
        ARStream(ar_pair[3], text, pos, segment_steps=7)


# ---- the engine -------------------------------------------------------------

@pytest.mark.parametrize("family", ["transformer", "ar"])
@pytest.mark.parametrize("chunk_frames", [8, 64])
def test_engine_stream_pcm_equals_oneshot_audio(family, chunk_frames,
                                                tmp_path):
    """FastSpeech 2 windows its one mel; the AR model feeds a
    ``VocoderSession`` (chunk 8: window 24 <= the 32-frame budget) or
    vocodes its chunks as one buffer (chunk 64)."""
    _, port_dir, kw = engine_pair(family, tmp_path)
    engine = TTSEngine(port_dir, **ENGINE, device="cpu",
                       vocoder=write_tiny_vocoder(tmp_path / "voc"), **kw)
    for text in ([1, 2, 3, 4, 5], list(range(20, 36))):
        ref = engine.synthesize([text])[0]
        events = list(engine.synthesize_streaming(
            text, chunk_frames=chunk_frames, segment_steps=8))
        assert events[-1]["type"] == "end"
        assert events[-1]["mel_frames"] == ref["mel"].shape[0]
        np.testing.assert_array_equal(events[-1]["durations"],
                                      ref["durations"])
        pcm = np.concatenate([e["pcm"] for e in events[:-1]])
        assert {e["type"] for e in events[:-1]} == {"audio"}
        np.testing.assert_allclose(pcm, ref["audio"], atol=1e-5, rtol=1e-5)


def test_engine_ar_mel_events_stop_at_the_length(tmp_path):
    _, port_dir, kw = engine_pair("gst", tmp_path)
    engine = TTSEngine(port_dir, **ENGINE, device="cpu", **kw)
    for text in ([1, 2, 3, 4, 5], list(range(3, 10)), list(range(20, 36))):
        ref = engine.synthesize([text])[0]
        events = list(engine.synthesize_streaming(text, segment_steps=8))
        n = events[-1]["mel_frames"]
        assert n == ref["mel"].shape[0]
        mels = [e for e in events if e["type"] == "mel"]
        assert [e["start_frame"] for e in mels] == [0] + list(
            np.cumsum([e["mel"].shape[0] for e in mels])[:-1])
        mel = np.concatenate([e["mel"] for e in mels])
        assert mel.shape[0] == n                # no frame past the length
        np.testing.assert_allclose(mel, ref["mel"], **_tol(ref["mel"]))
