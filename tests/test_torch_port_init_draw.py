"""The port's fresh-weight draw (``models.fastspeech2.init_parameters``)
against flax's own ``init`` of the same JAX modules.

For FastSpeech 2 (transformer and conformer stacks), the AR
Transformer-TTS, GST, the SQ-VAE FastSpeech 2 and the LSTM language model,
flax's jitted ``init`` is carried into the port's layout
(``compat/from_jax``) and every parameter of at least 1000 elements of the
port's own draw holds its std within 10 % of flax's; the leaves flax draws
LeCun truncated normal (Linear and Conv kernels, the RNNs' input kernels)
stay within 2 sigma; the RNNs' hidden kernels are orthogonal per gate;
every bias is 0. The draw the port had before (torch's uniform range,
N(0, 1) embeddings, no orthogonal kernels) fails the same check.
"""

import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.models.lm import (
    LSTMLanguageModel as JaxLSTMLanguageModel)
from transformer_tts_tpu.models.transformer_tts import (
    build_transformer_tts as jax_build_transformer_tts)
from transformer_tts_tpu.ops.masks import (
    create_masks as jax_create_masks, pad_mask as jax_pad_mask)
from transformer_tts_tpu.train.trainer import (
    build_fastspeech2 as jax_build_fastspeech2,
    build_sq_fastspeech2 as jax_build_sq_fastspeech2)
from transformer_tts_tpu_torch.compat.from_jax import (
    lm_state_dict_from_flax, state_dict_from_flax)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models import fastspeech2 as port_fs2
from transformer_tts_tpu_torch.models.fastspeech2 import (
    TRUNCATED_STD, build_fastspeech2)
from transformer_tts_tpu_torch.models.fastspeech2_sq import (
    build_sq_fastspeech2)
from transformer_tts_tpu_torch.models.lm import build_lstm_language_model
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts)
from transformer_tts_tpu_torch.models.variance_adaptor import UniLSTM

from torch_port_pair import AR, CONFORMER, SMALL

WIDE = dict(SMALL, d_model_encoder=64, d_model_decoder=64)
FAMILIES = {
    "fastspeech2": {},
    "conformer": CONFORMER,
    "ar": AR,
    "gst": dict(AR, gst=True),
    "sq": dict(model="SQFastSpeech2"),
}
MIN_SIZE = 1000
STD_TOL = 0.10
LM = (40, 64, 2)            # vocab, hidden, layers


def _flax_fastspeech2(cfg, seed):
    jhp = JaxHParams(**cfg)
    build = (jax_build_sq_fastspeech2 if cfg.get("model") == "SQFastSpeech2"
             else jax_build_fastspeech2)
    jmodel = build(jhp)
    b, l, t = 2, 8, 32
    text = jnp.ones((b, l), jnp.int32)
    src_mask = jax_pad_mask(jnp.ones((b, l), jnp.int32))
    return jax.jit(lambda key: jmodel.init(
        key, text, src_mask, t, jnp.full((b, l), 4, jnp.int32),
        jnp.zeros((b, t)), jnp.zeros((b, t)), train=False))(
        jax.random.PRNGKey(seed))


def _flax_ar(cfg, seed):
    jmodel = jax_build_transformer_tts(JaxHParams(**cfg))
    b, l, t = 2, 8, 6
    pos_text = jnp.tile(jnp.arange(1, l + 1)[None], (b, 1))
    pos_mel = jnp.tile(jnp.arange(1, t + 1)[None], (b, 1))
    src_mask, trg_mask = jax_create_masks(pos_text, pos_mel,
                                          model="transformer")
    ref_mel = jnp.zeros((b, 24, cfg["mel_dim"])) if cfg.get("gst") else None
    return jax.jit(lambda key: jmodel.init(
        key, jnp.ones((b, l), jnp.int32), jnp.zeros((b, t, cfg["mel_dim"])),
        src_mask, trg_mask, None, ref_mel=ref_mel, train=False))(
        jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def flax_draw(family):
    """{name: flax's ``init`` of ``family``} in the port's layout."""
    if family == "lm":
        vocab, hidden, layers = LM
        jlm = JaxLSTMLanguageModel(vocab_size=vocab, hidden_size=hidden,
                                   num_layers=layers)
        toks = jnp.zeros((2, 5), jnp.int32)
        params = jax.jit(lambda key: jlm.init(key, toks, toks))(
            jax.random.PRNGKey(1))["params"]
        return lm_state_dict_from_flax(params, layers)
    cfg = dict(WIDE, **FAMILIES[family])
    variables = (_flax_ar if family in ("ar", "gst")
                 else _flax_fastspeech2)(cfg, 1)
    return state_dict_from_flax(variables["params"],
                                variables.get("batch_stats", {}),
                                HParams(**cfg))


def draws(family):
    """-> (port model with its own draw, {name: flax's draw} in the port's
    layout)."""
    if family == "lm":
        model = build_lstm_language_model(*LM, device="cpu", seed=0)
    else:
        hp = HParams(**dict(WIDE, **FAMILIES[family]))
        build = (build_transformer_tts if family in ("ar", "gst")
                 else build_sq_fastspeech2 if family == "sq"
                 else build_fastspeech2)
        model = build(hp, device="cpu", seed=0)
    return model, flax_draw(family)


def _kinds(model):
    """name -> "truncated" (LeCun truncated normal, with its fan_in),
    "orthogonal" (with its gate count) or None, for every parameter."""
    kinds = {}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            kinds[prefix + "weight"] = ("truncated",
                                        module.weight[0].numel())
        elif isinstance(module, (nn.GRU, UniLSTM)):
            gates = 3 if isinstance(module, nn.GRU) else 4
            for name, p in module.named_parameters():
                if name.startswith("weight_hh"):
                    kinds[prefix + name] = ("orthogonal", gates)
                elif name.startswith("weight_ih"):
                    kinds[prefix + name] = ("truncated", p.shape[1])
    return kinds


def draw_faults(model, flax) -> list:
    """Every way the port's draw departs from flax's (empty when none)."""
    faults, kinds = [], _kinds(model)
    compared = 0
    for name, p in model.named_parameters():
        x = p.detach().double()
        if name.rsplit(".", 1)[-1].startswith("bias"):
            if bool((x != 0).any()):
                faults.append(f"{name}: a non-zero bias")
            continue
        kind = kinds.get(name)
        if kind and kind[0] == "truncated":
            bound = 2.0 / math.sqrt(kind[1]) / TRUNCATED_STD
            if x.abs().max().item() > bound * (1 + 1e-6):
                faults.append(f"{name}: beyond 2 sigma")
        elif kind and kind[0] == "orthogonal":
            for block in x.chunk(kind[1], dim=0):
                eye = torch.eye(block.shape[0], dtype=block.dtype)
                if not torch.allclose(block @ block.T, eye, atol=1e-5):
                    faults.append(f"{name}: a gate not orthogonal")
                    break
        if x.numel() < MIN_SIZE or name not in flax:
            continue
        compared += 1
        ours, theirs = x.std().item(), flax[name].double().std().item()
        if abs(ours - theirs) > STD_TOL * theirs:
            faults.append(f"{name}: std {ours:.4g} against flax's "
                          f"{theirs:.4g}")
    assert compared >= 3, "too few parameters to compare"
    return faults


@pytest.mark.parametrize("family", [*FAMILIES, "lm"])
def test_the_draw_is_flax(family):
    model, flax = draws(family)
    assert draw_faults(model, flax) == []
    # flax's own draw passes the same check, with the port's kinds
    model.load_state_dict(flax, strict=False)
    assert [f for f in draw_faults(model, flax)
            if "bias" not in f] == []


def _torch_range_draw(model, generator):
    """The draw the port had before: torch's uniform range, N(0, 1)
    embeddings, uniform RNN kernels."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d,
                                   nn.GRU, UniLSTM)):
                for name, p in module.named_parameters():
                    if name.startswith("bias"):
                        p.zero_()
                    else:
                        bound = 1.0 / math.sqrt(p[0].numel())
                        p.copy_(torch.rand(p.shape, generator=generator)
                                * 2 * bound - bound)
            elif isinstance(module, nn.Embedding):
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=generator))


@pytest.mark.parametrize("family", ["fastspeech2", "gst"])
def test_the_old_draw_fails(family, monkeypatch):
    monkeypatch.setattr(port_fs2, "init_parameters", _torch_range_draw)
    import transformer_tts_tpu_torch.models.transformer_tts as port_ar
    monkeypatch.setattr(port_ar, "init_parameters", _torch_range_draw)
    model, flax = draws(family)
    faults = draw_faults(model, flax)
    assert any("std" in f for f in faults)
    if family == "gst":
        assert any("orthogonal" in f for f in faults)


def test_each_kind_is_drawn_as_flax_draws_it():
    g = torch.Generator().manual_seed(0)
    w = torch.empty(512, 300)
    port_fs2.lecun_normal_(w, 300, g)
    assert abs(w.std().item() * math.sqrt(300) - 1.0) < 0.01
    assert w.abs().max().item() <= 2 / math.sqrt(300) / TRUNCATED_STD
    hh = torch.empty(4 * 64, 64)
    port_fs2.orthogonal_gates_(hh, 4, g)
    for block in hh.chunk(4):
        torch.testing.assert_close(block @ block.T, torch.eye(64),
                                   atol=1e-5, rtol=0)
    emb = nn.Embedding(1000, 64)
    port_fs2.init_parameters(emb, g)
    assert abs(emb.weight.std().item() * 8.0 - 1.0) < 0.02
