"""The port's weight-only int8 (infer/quantize.py) against the JAX package's
``quantize_tree`` on the CPU.

For every flax leaf of the small models (tests/torch_port_pair.py) and of
a vocoder, the port quantizes the tensor ``state_dict_from_flax`` writes
from it: the set of quantized tensors is the same, and ``q`` and ``s``
equal JAX's carried across by the same converter (exactly: the same fp32
division, rounding half to even). Linear, Conv1d, depthwise and 2-D
convolutions, ConvTranspose1d, embedding tables (a scale per feature
column: per row fails), the conformer's position biases, GST's GRU gates
and style tokens. The stats equal JAX's ``quantization_stats``; the int8
engine equals JAX's int8 engine at 1e-5 of max(1, max|ref|); the graphed
AR decode's bf16 copies follow the dequantized weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.infer.engine import TTSEngine as JaxTTSEngine
from transformer_tts_tpu.infer.quantize import (
    _is_qleaf, quantization_stats as jax_stats, quantize_tree)
from transformer_tts_tpu.vocoder.trainer import build_vocoder as jax_vocoder
from transformer_tts_tpu_torch.compat.from_jax import (
    QLeaf, flax_layouts, state_dict_from_flax, vocoder_flax_layouts,
    vocoder_state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer.engine import TTSEngine
from transformer_tts_tpu_torch.infer.quantize import (
    dequantize_state_dict, has_quantized, is_quantized, quantization_stats,
    quantize_parameters_, quantize_state_dict)
from transformer_tts_tpu_torch.infer.synthesize import DecodeWeights
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)

from torch_port_pair import (
    AR, CONFORMER, ENGINE, ENGINE_FAMILIES, ENGINE_TEXTS, SMALL,
    TINY_VOCODER, assert_results_match, build_ar_pair, build_pair,
    engine_pair)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# speaker tables of 12 rows (384 values at d 32: quantized at SMALL_LEAF)
SPEAKER_IDS = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
                   spk_emb_dim=12, spk_emb_architecture="encoder,decoder")
MODELS = {
    "transformer": (build_pair, {}),
    "conformer": (build_pair, CONFORMER),
    "sq": (build_pair, dict(model="SQFastSpeech2")),
    "ar": (build_ar_pair, {}),
    "gst": (build_ar_pair, dict(gst=True)),
    "speakers-transformer": (build_pair, dict(
        is_multi_speaker=True, spk_emb_type="x_vector", spk_emb_dim=512,
        spk_emb_architecture="encoder,middle,decoder", use_hop=True,
        accent_emb=True, CTC_training=True, use_pos=True,
        use_rnn_length=True)),
    "speakers-conformer": (build_pair, dict(
        SPEAKER_IDS, accent_emb=True, use_rnn_length=True, **CONFORMER)),
    "speakers-ar": (build_ar_pair, SPEAKER_IDS),
}
SMALL_LEAF = 256          # below every table of the small models


def _model_case(name):
    builder, extra = MODELS[name]
    hp, _, variables, _ = builder(**extra)
    cfg = dict(SMALL, **(AR if builder is build_ar_pair else {}), **extra)
    params, bstats = variables["params"], variables["batch_stats"]

    def convert(tree):
        return state_dict_from_flax(tree, bstats, hp)

    return HParams(**cfg), params, convert, flax_layouts(HParams(**cfg))


def _vocoder_case(mode):
    cfg = dict(mel_dim=16, **TINY_VOCODER, vocoder_upsample_mode=mode)
    jhp, hp = JaxHParams(**cfg), HParams(**cfg)
    gen = jax_vocoder(jhp, train_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 16))))["params"]
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: rs.randn(*x.shape).astype(np.float32), shapes)

    def convert(tree):
        return vocoder_state_dict_from_flax(tree, hp)

    return hp, params, convert, vocoder_flax_layouts(params, hp)


CASES = {**{m: (lambda m=m: _model_case(m)) for m in MODELS},
         "vocoder-transposed": lambda: _vocoder_case("transposed"),
         "vocoder-subpixel": lambda: _vocoder_case("subpixel")}


def _carried(jq, params, convert):
    """JAX's q, its scale broadcast to each leaf, and a 1/0 mark of the
    quantized leaves, each carried into the port's layout."""
    def pick(f):
        return jax.tree_util.tree_map(
            lambda q, w: np.asarray(f(q, w), np.float32), jq, params,
            is_leaf=_is_qleaf)
    return (convert(pick(lambda q, w: q["q"] if _is_qleaf(q) else w)),
            convert(pick(lambda q, w: np.broadcast_to(q["s"], w.shape)
                         if _is_qleaf(q) else w)),
            convert(pick(lambda q, w: np.full(w.shape, float(_is_qleaf(q))))))


def _assert_same_as_jax(params, convert, layouts, min_size):
    jq = quantize_tree(params, min_size=min_size)
    q_ref, s_ref, mark = _carried(jq, params, convert)
    state = convert(params)
    ours = quantize_state_dict(state, layouts, min_size=min_size)
    n = 0
    for name in layouts:
        assert is_quantized(ours[name]) == bool(mark[name].all()), name
        if is_quantized(ours[name]):
            n += 1
            assert torch.equal(ours[name]["q"].float(), q_ref[name]), name
            assert torch.equal(ours[name]["s"].expand_as(s_ref[name]),
                               s_ref[name]), name
        else:
            assert ours[name] is state[name]
    return n, jq, state, ours


@pytest.mark.parametrize("min_size", [SMALL_LEAF, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_q_and_s_equal_jax_for_every_leaf(case, min_size):
    _, params, convert, layouts = CASES[case]()
    n, jq, state, ours = _assert_same_as_jax(params, convert, layouts,
                                             min_size)
    assert n > 0 or min_size > SMALL_LEAF
    assert quantization_stats(state, ours, layouts) == pytest.approx(
        jax_stats(params, jq))
    # buffers (BatchNorm running statistics) pass through untouched
    for name, value in state.items():
        if name not in layouts:
            assert ours[name] is value
    deq = dequantize_state_dict(ours)
    assert not has_quantized(deq) and has_quantized(ours) == (n > 0)


def test_the_leaves_cover_what_the_layouts_hold():
    """Each kind of leaf the tests above see quantized at SMALL_LEAF."""
    kinds = set()
    for case in ("transformer", "conformer", "gst", "vocoder-transposed"):
        hp, params, convert, layouts = CASES[case]()
        ours = quantize_state_dict(convert(params), layouts,
                                   min_size=SMALL_LEAF)
        kinds |= {(layouts[n][0].axis, layouts[n][0].ndim,
                   layouts[n][0].blocks) for n in layouts
                  if is_quantized(ours[n])}
    # Linear, Conv1d (dim 0); embeddings, position biases, tokens (dim 1,
    # 2-D); ConvTranspose1d (dim 1, 3-D); Conv2d (4-D); GRU gates (3 blocks)
    assert {(0, 2, 1), (0, 3, 1), (1, 2, 1), (1, 3, 1), (0, 4, 1),
            (0, 2, 3)} <= kinds


def test_a_per_row_embedding_scale_fails():
    _, params, convert, layouts = CASES["transformer"]()
    emb = "encoder.embed.weight"
    assert layouts[emb] == [QLeaf(2, 1)]
    bad = dict(layouts, **{emb: [QLeaf(2, 0)]})
    with pytest.raises(AssertionError, match=emb):
        _assert_same_as_jax(params, convert, bad, SMALL_LEAF)


@pytest.mark.parametrize("case,table", [
    ("speakers-conformer", "encoder.layers.0.multi_emb.weight"),
    ("speakers-conformer", "encoder.acc_embed.weight"),
    ("speakers-ar", "decoder.layers.1.spk_bias.multi_emb.weight")])
def test_a_per_row_speaker_or_accent_scale_fails(case, table):
    """Speaker and accent tables scale per feature column, as JAX's
    ``quantize_tree`` scales an ``Embed``; per row fails."""
    _, params, convert, layouts = CASES[case]()
    assert layouts[table] == [QLeaf(2, 1)]
    _assert_same_as_jax(params, convert, layouts, SMALL_LEAF)
    bad = dict(layouts, **{table: [QLeaf(2, 0)]})
    with pytest.raises(AssertionError, match=table):
        _assert_same_as_jax(params, convert, bad, SMALL_LEAF)


def test_lstm_gates_quantize_per_gate_row():
    """The LSTM's stacked gates hold four flax kernels each, scaled per
    output row as JAX scales each kernel."""
    _, params, convert, layouts = CASES["speakers-conformer"]()
    name = "variance_adaptor.rnn_length.weight_ih_l0"
    assert layouts[name] == [QLeaf(2, 0, blocks=4)] * 4
    ours = quantize_state_dict(convert(params), layouts, min_size=SMALL_LEAF)
    assert is_quantized(ours[name])


def test_dequantized_values_are_within_half_a_step():
    _, params, convert, layouts = CASES["conformer"]()
    state = convert(params)
    ours = quantize_state_dict(state, layouts, min_size=SMALL_LEAF)
    deq = dequantize_state_dict(ours)
    for name in layouts:
        if is_quantized(ours[name]):
            assert ((deq[name] - state[name]).abs()
                    <= ours[name]["s"] / 2 + 1e-7).all(), name


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_int8_engine_matches_jax_int8_engine(family, tmp_path):
    jax_dir, port_dir, kw = engine_pair(family, tmp_path)
    jax_engine = JaxTTSEngine(jax_dir, **ENGINE, quantize="int8", **kw)
    engine = TTSEngine(port_dir, **ENGINE, quantize="int8", device="cpu",
                       **kw)
    assert engine.quantize_stats == pytest.approx(jax_engine.quantize_stats)
    assert engine.quantize_stats["n_quantized"] > 0
    assert_results_match(engine.synthesize(ENGINE_TEXTS),
                         jax_engine.synthesize(ENGINE_TEXTS))


def test_decode_weights_follow_the_dequantized_parameters():
    """The bf16 copies the graphed AR decode reads are re-taken from the
    parameters once ``quantize_parameters_`` writes q * s into them (its
    in-place copy bumps each tensor's ``_version``)."""
    hp = HParams(**dict(SMALL, **AR, amp=True))
    model = build_transformer_tts(hp, device="cpu")
    weights = DecodeWeights(model)
    assert weights.slots
    before = [copy.clone() for _, _, copy in weights.slots]
    quantize_parameters_(model, flax_layouts(hp), min_size=SMALL_LEAF)
    changed = 0
    for (mod, name, copy), old in zip(weights.slots, before):
        assert torch.equal(copy, old)           # not yet refreshed
        changed += not torch.equal(
            mod._parameters[name].to(torch.bfloat16), old)
    assert changed > 0
    weights.refresh()
    for mod, name, copy in weights.slots:
        assert torch.equal(copy, mod._parameters[name].to(torch.bfloat16))
