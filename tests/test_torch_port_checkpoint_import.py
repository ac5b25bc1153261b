"""Loading reference PyTorch checkpoints into the port, on the CPU.

For FastSpeech 2 (transformer and conformer stacks) and the AR
Transformer-TTS, a port ``state_dict`` is written as the reference writes
``network.epoch{N}`` (``torch.save``, under DataParallel's ``module.``
prefix): ``load_reference_checkpoint`` loads it back bit for bit, and the
JAX package's own converters of the same file give the JAX forward the
port's output, at the tolerance of each model's parity tests (1e-4). A
missing or unexpected key raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat import torch_import as jti
from transformer_tts_tpu.ops.masks import (
    create_masks as jax_create_masks, pad_mask as jax_pad_mask)
from transformer_tts_tpu_torch.compat.torch_import import (
    load_reference_checkpoint, strip_module_prefix)
from transformer_tts_tpu_torch.ops.masks import create_masks, pad_mask

from torch_port_pair import AR, CONFORMER, build_ar_pair, build_pair, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = {"fastspeech2": {}, "conformer": CONFORMER, "ar": AR}


@pytest.fixture(scope="module", params=list(FAMILIES))
def saved(request, tmp_path_factory):
    """(family, hp, port model, path of its reference-style file)."""
    family = request.param
    hp, _, _, model = (build_ar_pair() if family == "ar"
                       else build_pair(**FAMILIES[family]))
    path = tmp_path_factory.mktemp(family) / "network.epoch7"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)
    return family, hp, model, str(path)


def test_reference_checkpoint_loads_back_bit_for_bit(saved):
    family, hp, model, path = saved
    loaded = load_reference_checkpoint(path, hp, device="cpu")
    assert not loaded.training
    want = model.state_dict()
    got = loaded.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _jax_params(family, hp, state):
    """The JAX package's conversion of a reference state_dict."""
    if family == "ar":
        return jti.convert_transformer_state_dict(state, hp)
    if family == "fastspeech2":
        return jti.convert_fastspeech2_state_dict(state, hp)
    # conformer stacks: the JAX package converts them apart
    # (convert_conformer_encoder_state_dict), and the variance adaptor and
    # postnet as convert_fastspeech2_state_dict does
    s = jti._strip_module_prefix(state)
    params, bstats = {}, {}
    for stack, n in (("encoder", hp.n_layer_encoder),
                     ("decoder", hp.n_layer_decoder)):
        params[stack], bstats[stack] = \
            jti.convert_conformer_encoder_state_dict(s, n, prefix=stack)
    va = ("variance_adaptor",)
    for kind in ("duration", "pitch", "energy"):
        jti._map_variance_predictor(params, bstats, va + (
            f"{kind}_predictor",), s, f"variance_adaptor.{kind}_predictor")
        if kind != "duration":
            jti._map_embed(params, bstats, va + (f"{kind}_embedding",), s,
                           f"variance_adaptor.{kind}_embedding")
    pn = ("postnet",)
    jti._map_linear(params, bstats, pn + ("out",), s, "postnet.out")
    jti._map_conv1d(params, bstats, pn + ("conv1",), s, "postnet.conv1")
    jti._map_conv1d(params, bstats, pn + ("conv2",), s, "postnet.conv2")
    jti._map_bn(params, bstats, pn + ("pre_batchnorm",), s,
                "postnet.pre_batchnorm")
    for i in range(3):
        jti._map_conv1d(params, bstats, pn + (f"conv_list_{i}",), s,
                        f"postnet.conv_list.{i}")
        jti._map_bn(params, bstats, pn + (f"batch_norm_list_{i}",), s,
                    f"postnet.batch_norm_list.{i}")
    return params, bstats


def _text(seed, b=2, l=12, vocab=40):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, vocab, (b, l)).astype(np.int32)
    text[1, l - 3:] = 0
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    return text, pos


def test_reference_checkpoint_gives_jax_the_ports_output(saved):
    family, hp, _, path = saved
    jmodel = (build_ar_pair if family == "ar" else build_pair)(
        **({} if family == "ar" else FAMILIES[family]))[1]
    state = torch.load(path, map_location="cpu", weights_only=True)
    params, bstats = _jax_params(family, hp, state)
    variables = {"params": params, "batch_stats": bstats}
    model = load_reference_checkpoint(path, hp, device="cpu")
    text, pos = _text(1)
    rs = np.random.RandomState(2)
    if family == "ar":
        t = 6
        mel = rs.randn(2, t, hp.mel_dim).astype(np.float32)
        pos_mel = np.tile(np.arange(1, t + 1)[None], (2, 1)).astype(np.int32)
        pos_mel[1, -2:] = 0
        j_src, j_trg = jax_create_masks(jnp.asarray(pos), jnp.asarray(
            pos_mel), model="transformer")
        ref = jmodel.apply(variables, jnp.asarray(text), jnp.asarray(mel),
                           j_src, j_trg, train=False)
        src, trg = create_masks(torch.as_tensor(pos),
                                torch.as_tensor(pos_mel),
                                model="transformer")
        with torch.no_grad():
            ours = model(torch.as_tensor(text).long(),
                         torch.as_tensor(mel), src, trg)
        fields = ("mel_pre", "mel_post", "stop_token")
    else:
        t = 48
        d = rs.randint(0, 5, text.shape).astype(np.int32) * (text != 0)
        p = rs.uniform(60, 800, (2, t)).astype(np.float32)
        e = rs.uniform(0, 320, (2, t)).astype(np.float32)
        ref = jmodel.apply(variables, jnp.asarray(text),
                           jax_pad_mask(jnp.asarray(pos)), t, jnp.asarray(d),
                           jnp.asarray(p), jnp.asarray(e), train=False)
        with torch.no_grad():
            ours = model(torch.as_tensor(text),
                         pad_mask(torch.as_tensor(pos)), t,
                         torch.as_tensor(d), torch.as_tensor(p),
                         torch.as_tensor(e))
        fields = ("mel_pre", "mel_post", "log_duration",
                  "variance_adaptor_output")
    for field in fields:
        np.testing.assert_allclose(to_np(getattr(ours, field)),
                                   to_np(getattr(ref, field)), **TOL,
                                   err_msg=field)


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_missing_or_unexpected_key_raises(saved, tmp_path, fault):
    family, hp, model, path = saved
    state = torch.load(path, map_location="cpu", weights_only=True)
    if fault == "missing":
        state.pop(next(iter(state)))
    else:
        state["module.extra.weight"] = torch.zeros(1)
    bad = tmp_path / "network.epoch1"
    torch.save(state, bad)
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        load_reference_checkpoint(str(bad), hp, device="cpu")


def test_unprefixed_file_loads_and_ar_postnet_can_be_the_identity(
        tmp_path):
    hp, _, _, model = build_ar_pair()
    path = tmp_path / "network.epoch2"
    torch.save(model.state_dict(), path)
    loaded = load_reference_checkpoint(str(path), hp, device="cpu",
                                       identity_compat=True)
    assert loaded.postnet.identity_compat
    mel = torch.randn(2, 6, hp.mel_dim * hp.reduction_rate)  # r frames
    with torch.no_grad():
        np.testing.assert_array_equal(to_np(loaded.postnet(mel)),
                                      to_np(mel))


@pytest.mark.parametrize("state", [
    {}, {"a": 1, "b": 2}, {"module.a": 1, "module.b": 2},
    {"a": 1, "module.b": 2}])
def test_strip_module_prefix_matches_jax(state):
    assert strip_module_prefix(state) == jti._strip_module_prefix(state)


def test_loader_defaults_to_the_card(saved):
    import inspect
    assert inspect.signature(load_reference_checkpoint).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        _, hp, _, path = saved
        with pytest.raises((RuntimeError, AssertionError)):
            load_reference_checkpoint(path, hp)
