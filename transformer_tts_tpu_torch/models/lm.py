"""The LSTM language model over discrete dual-token outputs (the port of
``LSTMLanguageModel``, transformer_tts_tpu/models/lm.py:14-35): two
embeddings, one per token stream, summed; ``num_layers`` unidirectional
LSTMs; two heads, one logit stream per token stream. It rescores the
discrete (``output_type``) outputs; no trainer of either package builds
it.

Each LSTM is a ``UniLSTM`` (models/variance_adaptor.py): torch's
``nn.LSTM`` layout, a zero input bias outside the ``state_dict`` and the
gradient, fp32 with autocast off (cuDNN's LSTM on the card);
compat/from_jax.lm_state_dict_from_flax carries flax's
``OptimizedLSTMCell_<i>`` into ``lstms.<i>``.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_tts_tpu_torch.models.fastspeech2 import init_parameters
from transformer_tts_tpu_torch.models.variance_adaptor import UniLSTM


class LSTMLanguageModel(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 512,
                 num_layers: int = 4):
        super().__init__()
        self.embed1 = nn.Embedding(vocab_size, hidden_size)
        self.embed2 = nn.Embedding(vocab_size, hidden_size)
        self.lstms = nn.ModuleList(UniLSTM(hidden_size, hidden_size)
                                   for _ in range(num_layers))
        self.out1 = nn.Linear(hidden_size, vocab_size)
        self.out2 = nn.Linear(hidden_size, vocab_size)

    def forward(self, tokens1: torch.Tensor, tokens2: torch.Tensor):
        """(B, T) x 2 int token streams -> two (B, T, vocab) logit
        streams."""
        x = self.embed1(tokens1) + self.embed2(tokens2)
        for lstm in self.lstms:
            x = lstm(x)
        return self.out1(x), self.out2(x)


def build_lstm_language_model(vocab_size: int = 320, hidden_size: int = 512,
                              num_layers: int = 4, *, device="cuda",
                              seed: int = 0) -> LSTMLanguageModel:
    """An ``LSTMLanguageModel`` with random weights from ``seed``
    (``init_parameters``, as every model of the port), on ``device``."""
    model = LSTMLanguageModel(vocab_size, hidden_size, num_layers)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
