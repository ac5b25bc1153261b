"""SQ-VAE stochastic quantization codebook (the port of ``SQEmbedding``,
transformer_tts_tpu/models/sq_vae.py:23-88, with ``param_var_q =
'gaussian_1'``, the one scalar log-variance the models use).

* distances: 0.5 * sum_d exp(-log_var_q) * (e_m - x_n)^2 to each code of a
  codebook drawn from N(0, 1), in the broadcast form (N, M, D) of the JAX
  package, which the expanded ||e||^2 - 2 e.x + ||x||^2 would round
  differently and could flip an argmin with;
* ``encode``: the argmin code, deterministic (eval);
* the stochastic call (train): Gumbel-softmax over -distances at
  ``temperature``, the codebook mixed by those weights; the ELBO term
  mean_b [0.5 sum precision (x - q)^2 + sum softmax(-dist) log
  softmax(-dist)] and the codebook perplexity of the argmin codes.

The Gumbel noise -log(-log(U)), U uniform in [tiny, 1) as
``jax.random.gumbel`` draws it, comes from an explicit generator on the
input's device: ``generator`` itself when it lives there, else a
generator there seeded from a draw of ``generator`` (the train state's
CPU generator), so the draw never waits for the card. ``gumbel`` replaces
the draw (the parity tests inject JAX's noise). Everything runs in fp32
with autocast off, as the flax module has no ``dtype``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The codebook size of every SQ-VAE model (``n_embeddings`` in the JAX
# package, which no hparam sets).
N_CODES = 128


def device_generator(generator: Optional[torch.Generator],
                     device) -> Optional[torch.Generator]:
    """``generator`` itself when it lies on ``device`` (or is None), else a
    generator on ``device`` seeded by one draw of it, so that a CPU
    train-state generator never waits for the card."""
    device = torch.device(device)
    if generator is None or generator.device.type == device.type:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def gumbel_noise(shape, device, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """-log(-log(U)) of ``shape`` on ``device``, U in [tiny, 1) fp32."""
    generator = device_generator(generator, device)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, device=device, generator=generator)
    u = u * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


class SQEmbedding(nn.Module):
    def __init__(self, n_embeddings: int, embedding_dim: int):
        super().__init__()
        self.n_embeddings = n_embeddings
        self.embedding_dim = embedding_dim
        self.embedding = nn.Parameter(torch.zeros(n_embeddings,
                                                  embedding_dim))

    def distances(self, x_flat: torch.Tensor,
                  log_var_q: torch.Tensor) -> torch.Tensor:
        """(N, D) fp32 -> (N, M) Mahalanobis distances, the (N, M, D)
        broadcast form."""
        precision = torch.exp(-log_var_q.float().reshape(1, 1, 1))
        diff = self.embedding[None, :, :] - x_flat[:, None, :]
        return 0.5 * torch.sum(precision * diff ** 2, dim=-1)

    def encode(self, x: torch.Tensor, log_var_q: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(quantized fp32 of x's shape, argmin indices of x's shape[:-1])."""
        with torch.autocast(x.device.type, enabled=False):
            x_flat = x.float().reshape(-1, self.embedding_dim)
            indices = torch.argmin(self.distances(x_flat, log_var_q), dim=-1)
            quantized = self.embedding[indices].reshape(x.shape)
        return quantized, indices.reshape(x.shape[:-1])

    def forward(self, x: torch.Tensor, log_var_q: torch.Tensor,
                temperature, *, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None):
        """Stochastic quantization of (B, T, D) ``x``: returns (quantized
        fp32, loss, perplexity, indices (B, T)). ``gumbel`` (N, M), when
        given, is the noise."""
        b, t, _ = x.shape
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            x_flat = x.reshape(-1, self.embedding_dim)
            dist = self.distances(x_flat, log_var_q)
            indices = torch.argmin(dist, dim=-1)
            logits = -dist
            if gumbel is None:
                gumbel = gumbel_noise(logits.shape, x.device, generator)
            encodings = torch.softmax((logits + gumbel) / temperature, -1)
            quantized = (encodings @ self.embedding).reshape(x.shape)

            logits_btm = logits.reshape(b, t, self.n_embeddings)
            probs = torch.softmax(logits_btm, dim=-1)
            log_probs = torch.log_softmax(logits_btm, dim=-1)
            precision = torch.exp(-log_var_q.float())
            loss = torch.mean(
                0.5 * torch.sum(precision * (x - quantized) ** 2, dim=(1, 2))
                + torch.sum(probs * log_probs, dim=(1, 2)))
            onehot = F.one_hot(indices, self.n_embeddings).float()
            avg_probs = onehot.mean(dim=0)
            perplexity = torch.exp(
                -torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return quantized, loss, perplexity, indices.reshape(b, t)
