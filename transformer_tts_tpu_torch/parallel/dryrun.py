"""One tensor- and data-parallel train step on n ranks at tiny shapes (the
port of ``dryrun_multichip`` in the JAX package's driver entry point).

``dryrun_multichip(n, device)`` spawns n ranks (``torch.multiprocessing``,
a free 127.0.0.1 port): NCCL with one card per rank for ``device="cuda"``,
gloo for ``device="cpu"``. With n >= 4 and even, the mesh is (data = n/2,
model = 2) (parallel/mesh.py) and the FastSpeech 2 step runs with its
heads and FFN channels split over ``model`` (parallel/tp.py) and DDP over
``data``; otherwise a data mesh alone. Then the AR Transformer-TTS step
runs data-parallel on the same mesh (every rank of a ``model`` group on its
data coordinate's rows, as JAX replicates that state over the mesh). Rank 0
prints the JAX entry point's two lines.

    python -c "from transformer_tts_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import numpy as np
import torch

TINY = dict(d_model_encoder=64, d_model_decoder=64, n_layer_encoder=2,
            n_layer_decoder=2, n_head_encoder=2, n_head_decoder=2,
            vocab_size=40, mel_dim=16, amp=False)


def _hparams(n: int, **kw):
    from transformer_tts_tpu_torch.config import HParams
    return HParams(**dict(TINY, batch_size=2 * n, **kw))


def _batch(b: int, l: int, t: int, mel_dim: int, vocab: int,
           seed: int = 0) -> dict:
    """The JAX entry point's batch: every row full, t // l frames per
    phone."""
    rs = np.random.RandomState(seed)
    return {
        "text": rs.randint(1, vocab, (b, l)).astype(np.int32),
        "pos_text": np.tile(np.arange(1, l + 1, dtype=np.int32)[None],
                            (b, 1)),
        "mel": rs.randn(b, t, mel_dim).astype(np.float32),
        "pos_mel": np.tile(np.arange(1, t + 1, dtype=np.int32)[None],
                           (b, 1)),
        "alignment": np.full((b, l), t // l, np.int32),
        "f0": (rs.rand(b, t) * 300 + 80).astype(np.float32),
        "energy": (rs.rand(b, t) * 100).astype(np.float32),
    }


def _rows(batch: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in batch.items()}


def _rank(rank: int, n: int, port: int, device: str, out: dict) -> None:
    import torch.distributed as dist

    from transformer_tts_tpu_torch.parallel import mesh as pm
    from transformer_tts_tpu_torch.train import trainer as tr
    torch.set_num_threads(1)
    dev = pm.init_distributed(f"127.0.0.1:{port}", n, rank, device=device)
    try:
        tp = 2 if n >= 4 and n % 2 == 0 else 1
        mesh = pm.make_mesh(n // tp, tp, device=device)
        hp = _hparams(n)
        state = tr.init_fastspeech2_state(hp, device=dev)
        state = tr.distribute(state, dev, mesh)
        batch = _batch(2 * n, 8, 32, hp.mel_dim, hp.vocab_size)
        rows = pm.batch_rows(mesh, 2 * n)
        _, logs = tr.make_fastspeech2_train_step(hp, device=dev)(
            state, _rows(batch, rows))
        loss = float(logs["loss_total"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        hp_ar = _hparams(n, model="Transformer", reduction_rate=2,
                         ff_conv_kernel_size_decoder=1)
        ar = tr.init_transformer_state(hp_ar, device=dev)
        ar = tr.distribute(ar, dev)
        ar_batch = _batch(2 * n, 8, 32, hp_ar.mel_dim, hp_ar.vocab_size,
                          seed=1)
        ar_batch["stop_token"] = np.zeros((2 * n, 32), np.float32)
        ar_batch["stop_token"][:, -2:] = 1.0
        del ar_batch["alignment"], ar_batch["f0"], ar_batch["energy"]
        _, ar_logs = tr.make_transformer_train_step(hp_ar, device=dev)(
            ar, _rows(ar_batch, rows))
        ar_loss = float(ar_logs["loss_total"])
        if not np.isfinite(ar_loss):
            raise FloatingPointError(f"non-finite AR loss {ar_loss}")
        if rank == 0:
            print(f"dryrun_multichip({n}): mesh=(data={n // tp}, "
                  f"model={tp}) loss={loss:.4f} OK")
            print(f"dryrun_multichip({n}): AR transformer DP step "
                  f"loss={ar_loss:.4f} OK")
        out[rank] = (loss, ar_loss)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """Run the steps on ``n`` ranks; returns {rank: (FastSpeech 2 loss, AR
    loss)}, which every rank of a step logs alike."""
    import socket

    import torch.multiprocessing as mp
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards (one NCCL rank "
                           f"each); this host has "
                           f"{torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with mp.get_context("spawn").Manager() as manager:
        out = manager.dict()
        mp.spawn(_rank, args=(n, port, device, out), nprocs=n, join=True)
        return dict(out)
