"""The port's models. ``build_model`` builds the one ``hp.model`` names."""

from torch import nn

from transformer_tts_tpu_torch.config import (
    HParams, is_nar_model, is_sq_model)


def build_model(hp: HParams, *, device="cuda", seed: int = 0) -> nn.Module:
    """The model ``hp.model`` names, with random weights from ``seed``: the
    AR Transformer-TTS, the SQ-VAE FastSpeech 2 or FastSpeech 2."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.models.fastspeech2_sq import (
        build_sq_fastspeech2)
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    if not is_nar_model(hp.model):
        build = build_transformer_tts
    elif is_sq_model(hp.model):
        build = build_sq_fastspeech2
    else:
        build = build_fastspeech2
    return build(hp, device=device, seed=seed)
