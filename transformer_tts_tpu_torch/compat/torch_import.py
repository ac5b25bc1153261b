"""Load a reference PyTorch checkpoint into the port (the port of
``load_reference_checkpoint`` and ``_strip_module_prefix``,
transformer_tts_tpu/compat/torch_import.py:40-43, :197-201).

The reference saves ``model.state_dict()`` as ``network.epoch{N}``, under
DataParallel's ``module.`` prefix when it trained on several cards. The
port's modules carry the reference's parameter names, so loading is
``torch.load``, the prefix stripped, and a strict ``load_state_dict`` into
the model that ``hp`` builds (``models.build_model``): FastSpeech 2
(transformer or conformer stacks), the SQ-VAE FastSpeech 2 or the AR
Transformer-TTS, with GST when ``hp.gst`` and the Tacotron 2 decoder when
``hp.decoder_type`` is "tacotron2" (its ``L_l1_ys`` ... ``AttentionSelfProj``
and ``AttentionConv`` under the reference's names, as the JAX package's
``_map_tacotron2_decoder`` maps them). Where the JAX package converts
the tensors into flax trees (one ``convert_*_state_dict`` per family),
the port renames nothing.

The reference's AR postnet returns its input unchanged (its
``prev_version=False`` branch); ``identity_compat=True`` makes the loaded
AR model do the same, as the JAX package's ``postnet_identity_compat``.

``load_post_low_energy_checkpoint`` is the counterpart of
``convert_post_low_energy_state_dict`` (:413-452): a reference
PostLowEnergy v1/v2 student (``hp.version``; ``linear1``, ``linear2``,
``linear_xvector``, the EMA VQ's ``vq_encoder_lmfb`` and
``quantize_lmfb`` buffers, ``encoder``, ``out``) loads strictly into
models/fastspeech2.build_post_model's student. A ``post_conformer``
student raises ``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams, is_nar_model


def strip_module_prefix(state: Dict) -> Dict:
    """Drop DataParallel's ``module.`` prefix, if the keys carry it."""
    if state and next(iter(state)).startswith("module."):
        return {k[len("module."):]: v for k, v in state.items()}
    return dict(state)


def load_reference_checkpoint(path: str, hp: HParams, *, device="cuda",
                              identity_compat: bool = False) -> nn.Module:
    """The model ``hp`` describes on ``device``, in eval mode, holding the
    weights of the reference checkpoint at ``path``. A missing or an
    unexpected key raises."""
    from transformer_tts_tpu_torch.models import build_model
    model = build_model(hp, device=device)
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(strip_module_prefix(state), strict=True)
    if not is_nar_model(hp.model):
        model.postnet.identity_compat = identity_compat
    return model.eval()


def load_post_low_energy_checkpoint(path: str, hp: HParams, *,
                                    device="cuda") -> nn.Module:
    """The mel-to-mel student ``hp`` describes on ``device``, in eval mode,
    holding the reference checkpoint at ``path``. A missing or an
    unexpected key raises."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_post_model)
    if hp.post_conformer:
        raise NotImplementedError(
            "post_conformer student: the reference's conformer students "
            "have no converter in the JAX package either")
    model = build_post_model(hp, device=device)
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(strip_module_prefix(state), strict=True)
    return model.eval()
