"""The port's data parallelism, sequence parallelism and training tools
against a single process and the JAX package, on the CPU.

Two gloo ranks (``torch.multiprocessing``, a free port) run one DDP train
step of a small FastSpeech 2 on halves of a global batch whose rows hold
different numbers of valid frames: the transformer stacks with the
postnet's BatchNorm, the conformer (its conv modules' BatchNorm) and the
``f0_stats`` mode (masked means of f0 and energy). Each rank's loss,
gradients, weights and BatchNorm statistics equal the single-process
port step on the whole batch at fp32 tightness and JAX's jitted
global-batch step at the tolerances of tests/test_torch_port_train.py;
per-rank BatchNorm statistics or per-rank denominators fail that check
by at least 10x. The same ranks run an accumulation of two micro-steps
(the first under ``no_sync``), draw their dropout streams, run
sequence-parallel attention and the mel-to-mel student's step (its EMA
codebook moved by the global batch, the NaN guard deciding over both
ranks, with and without accumulation, and the semantic mask's
time-weighted L1 over the group's counts), and the training CLI's
``--multihost`` runs at two ranks. Beside them: ``shard_batches``, the fixed-shape and
prefetching loader and the native mel reader against the JAX package's
data layer, RAdam against ``reference_radam``, the remat step against
the plain one with dropout on, every family's step giving every
parameter a gradient, and the evaluation and duration tools and
SpecAugment against the JAX package's.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.train import schedule
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_fastspeech2_train_step)

SMALL = dict(vocab_size=40, mel_dim=16, d_model_encoder=32,
             d_model_decoder=32, n_layer_encoder=2, n_layer_decoder=2,
             n_head_encoder=2, n_head_decoder=2,
             ff_conv_kernel_size_encoder=5, ff_conv_kernel_size_decoder=1,
             amp=False, dropout=0.0, dropout_postnet=0.0,
             dropout_variance_adaptor=0.0)
WARMUP = 10
FAMILIES = {
    "transformer": dict(warmup_step=WARMUP),
    "conformer": dict(warmup_step=WARMUP, encoder_type="conformer",
                      decoder_type="conformer"),
    "f0_stats": dict(warmup_step=WARMUP, f0_mean=300.0, f0_std=120.0,
                     energy_mean=150.0, energy_std=80.0),
}
# dropout 0.1 everywhere: the decoder's kernel dropout (seeds from the
# state's generator), the plain dropouts (torch's default generator)
REMAT_DROPOUT = dict(FAMILIES["transformer"], dropout=0.1,
                     dropout_postnet=0.1, dropout_variance_adaptor=0.1)
# each rank's misreading, and the family it breaks
VARIANTS = {"per_rank_statistics": "transformer",
            "per_rank_denominators": "f0_stats"}
# fp32 tightness: the ranks' sums against one process's (a different order
# of the same additions); JAX's, tests/test_torch_port_train.py's
TIGHT = dict(logs=1e-6, grad=2e-6, rtol=1e-6, atol=5e-7)
JAX_TOL = dict(logs=1e-4, grad=1e-4, rtol=1e-5, atol=1e-6)
# the mel-to-mel students on the pregenerated corpus: the EMA codebook
# (vq_code), and the NaN guard (v1, with and without accumulation)
POST = {"post_vq": dict(version=3, phone_embed=True, vq_code=True),
        "post_nan": dict(version=1),
        "post_nan_accum": dict(version=1, accum_grad=2)}
# post_nan_accum: the first accumulation's last micro-step and the next
# one's first skip, so the weights moved once (past one update Adam's
# normalised steps of rounding-noise gradients part any two sums)
POST_BATCHES = {"post_vq": (0, 1), "post_nan": (0, 1),
                "post_nan_accum": (0, 1, 2)}
NAN_BATCHES = (1, 2)        # a NaN planted in rank 1's half of these
SP_SHAPE = (2, 2, 64, 16)
SP_K_LEN = (64, 40)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread each, so the
    module's tests (and the spawned ranks) do not spin against the other
    test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def global_batch(seed=0, lengths=(12, 11, 6, 4), l=12, t=256, mel_dim=16,
                 frames=(10, 22)):
    """A FastSpeech 2 batch whose halves hold different numbers of valid
    phones and frames (rank 0 the first two rows)."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    text = rs.randint(1, 40, (b, l)).astype(np.int32)
    text *= np.arange(l)[None] < np.asarray(lengths)[:, None]
    pos_text = np.where(text != 0, np.arange(1, l + 1)[None],
                        0).astype(np.int32)
    dur = rs.randint(*frames, (b, l)).astype(np.int32) * (text != 0)
    mel_len = dur.sum(1)
    assert mel_len.max() <= t
    pos_mel = np.where(np.arange(t)[None] < mel_len[:, None],
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    f0 = np.zeros((b, t), np.float32)
    energy = np.zeros((b, t), np.float32)
    for i, n in enumerate(mel_len):
        mel[i, :n] = rs.randn(n, mel_dim)
        f0[i, :n] = rs.uniform(60, 800, n)
        energy[i, :n] = rs.uniform(0, 315, n)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                alignment=dur, f0=f0, energy=energy)


def rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def post_hparams(job):
    return HParams(**dict(SMALL, architecture="mel-mel",
                          teacher_suffix="_gen", mel_dim_post=16,
                          n_layer_post_model=1, warmup_step=WARMUP,
                          **POST[job]))


def post_batches(job):
    """``global_batch``es with a teacher mel and phone features, a NaN in
    the teacher mel of row 3 (rank 1's) for the NaN jobs."""
    out = []
    for seed in POST_BATCHES[job]:
        b = global_batch(seed=seed)
        rs = np.random.RandomState(100 + seed)
        valid = (b["pos_mel"] > 0)[..., None]
        b["teacher_mel"] = np.where(valid, rs.randn(*b["mel"].shape),
                                    -5.0).astype(np.float32)
        b["teacher_phone"] = np.where(valid, rs.randn(*valid.shape[:2], 32),
                                      0.0).astype(np.float32)
        if job != "post_vq" and seed in NAN_BATCHES:
            b["teacher_mel"][3, 5, 2] = np.nan
        out.append(b)
    return out


def post_state(job, weights):
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_post_model)
    hp = post_hparams(job)
    model = build_post_model(hp, device="cpu")
    model.load_state_dict(weights)
    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return hp, TrainState(model, opt, torch.Generator().manual_seed(0))


def port_state(cfg, weights, accum_grad=1):
    hp = HParams(**dict(SMALL, **cfg, accum_grad=accum_grad))
    model = build_fastspeech2(hp, device="cpu")
    model.load_state_dict(weights)
    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return hp, TrainState(model, opt, torch.Generator().manual_seed(0))


def snapshot(state, logs):
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters()},
            "weights": {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}}


# ---- the two ranks ----------------------------------------------------------

def _ddp_scenario(rank, world, cfg, weights, batches, variant=None,
                  accum_grad=1):
    from transformer_tts_tpu_torch.parallel import set_norm_group
    from transformer_tts_tpu_torch.train import losses, trainer
    hp, state = port_state(cfg, weights, accum_grad)
    state = trainer.distribute(state, "cpu")
    if variant == "per_rank_statistics":
        set_norm_group(state.model, None)
    if variant == "per_rank_denominators":
        state.means = lambda: losses.global_means(None)
    step = make_fastspeech2_train_step(hp, device="cpu")
    half = batches[0]["text"].shape[0] // world
    for batch in batches:
        state, logs = step(state, rows(batch, rank * half,
                                       (rank + 1) * half))
    return snapshot(state, logs)


def _post_scenario(rank, world, job, weights, variant=None):
    """A distributed mel-to-mel student's steps on the halves of
    ``post_batches(job)``; ``per_rank_codebook`` moves the EMA codebook by
    the rank's batch alone."""
    from transformer_tts_tpu_torch.parallel import set_norm_group
    from transformer_tts_tpu_torch.train import post_trainers, trainer
    hp, state = post_state(job, weights)
    state = trainer.distribute(state, "cpu")
    if variant == "per_rank_codebook":
        set_norm_group(state.model, None)
    step = post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")
    out = {"skipped": []}
    for i, batch in enumerate(post_batches(job)):
        half = batch["mel"].shape[0] // world
        state, logs = step(state, rows(batch, rank * half,
                                       (rank + 1) * half))
        out["skipped"].append(bool(logs["skipped_nan"]))
        out["first" if i == 0 else "last"] = snapshot(state, logs)
    return out


def _time_weighted_l1(rank, world, pred, target, mask):
    """The rank's half of ``time_weighted_l1`` over the group's counts:
    its value and its gradient."""
    from transformer_tts_tpu_torch.train import losses
    half = pred.shape[0] // world
    part = pred[rank * half:(rank + 1) * half].clone().requires_grad_(True)
    with losses.global_means(dist.group.WORLD):
        loss = losses.time_weighted_l1(
            part, target[rank * half:(rank + 1) * half],
            mask[rank * half:(rank + 1) * half], (0.7, 0.3), 16)
    loss.backward()
    return {"loss": float(loss), "grad": part.grad}


def _resume_scenario(rank, world, cfg, weights, batches, save_dir):
    """An accumulation of two micro-steps under DDP, saved after the
    first (epoch 1, with the optimizer) and resumed into a fresh state
    for the second, as cli/train.py resumes."""
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    from transformer_tts_tpu_torch.train import trainer
    half = batches[0]["text"].shape[0] // world
    hp, state = port_state(cfg, weights, accum_grad=2)
    state = trainer.distribute(state, "cpu")
    step = make_fastspeech2_train_step(hp, device="cpu")
    state, _ = step(state, rows(batches[0], rank * half, (rank + 1) * half))
    ckpt.save_train_checkpoint(save_dir, state, 1, hp)
    hp, state = port_state(cfg, weights, accum_grad=2)
    state, epoch = ckpt.restore_train_checkpoint(save_dir, state)
    assert epoch == 1 and state.optimizer.mini_step == 1
    state = trainer.distribute(state, "cpu")
    state, logs = step(state, rows(batches[1], rank * half,
                                   (rank + 1) * half))
    return snapshot(state, logs)


def _dropout_draws(cfg, weights):
    """The first in-kernel dropout seed and default-generator draw of a
    distributed state (every rank builds the same state)."""
    from transformer_tts_tpu_torch.ops.attention import _kernel_dropout
    from transformer_tts_tpu_torch.train import trainer
    torch.manual_seed(0)
    _, state = port_state(cfg, weights)
    before = int(torch.randint(0, 2 ** 62, (), generator=state.generator))
    _, state = port_state(cfg, weights)
    torch.manual_seed(0)
    state = trainer.distribute(state, "cpu")
    attn = state.model.decoder.layers[0].attn.train()
    attn.dropout.p = 0.1
    _, seed = _kernel_dropout(attn, state.generator)
    keep = torch.nn.functional.dropout(torch.ones(64), 0.5)
    return {"before": before, "seed": seed, "keep": keep}


def _sp(rank, world, q, k, v, do, k_len):
    from transformer_tts_tpu_torch.parallel import (
        sequence_parallel_attention)
    n = q.shape[2] // world
    part = [x[:, :, rank * n:(rank + 1) * n].clone().requires_grad_(True)
            for x in (q, k, v)]
    out = sequence_parallel_attention(*part, k_len)
    out.backward(do[:, :, rank * n:(rank + 1) * n])
    with pytest.raises(NotImplementedError, match="non-causal"):
        sequence_parallel_attention(*part, k_len, causal=True)
    return {"out": out.detach(), "dq": part[0].grad, "dk": part[1].grad,
            "dv": part[2].grad}


def _replication(rank, cfg, weights):
    """Rank 1 starts from other weights and its own BatchNorm statistics;
    after ``distribute`` it holds rank 0's (DDP's broadcast). Then local
    batches of two shapes are refused on both ranks."""
    from transformer_tts_tpu_torch.parallel import check_local_batch
    from transformer_tts_tpu_torch.train import trainer
    _, state = port_state(cfg, weights)
    if rank == 1:
        with torch.no_grad():
            for t in state.model.state_dict().values():
                if t.is_floating_point():
                    t.add_(1.0)
    state = trainer.distribute(state, "cpu")
    same = all(torch.equal(v, weights[k])
               for k, v in state.model.state_dict().items())
    check_local_batch({"mel": np.zeros((2, 64, 16))})
    with pytest.raises(ValueError, match="differ in shape"):
        check_local_batch({"mel": np.zeros((2, 64 * (rank + 1), 16))})
    return {"rank0_weights": same}


def _stop_agreement(rank):
    """Rank 1 alone caught a SIGTERM: both ranks stop at the step."""
    from transformer_tts_tpu_torch.cli.train import stop_agreement
    stop = stop_agreement({"stop": rank == 1}, 2)
    return {"stop": stop()}


def _rank_main(rank, port, jobs, out_dir):
    from transformer_tts_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        results = {}
        for name, job in jobs.items():
            kind = job.pop("kind")
            if kind == "step":
                results[name] = _ddp_scenario(rank, 2, **job)
            elif kind == "resume":
                results[name] = _resume_scenario(rank, 2, **job)
            elif kind == "dropout":
                results[name] = _dropout_draws(**job)
            elif kind == "stop":
                results[name] = _stop_agreement(rank)
            elif kind == "replication":
                results[name] = _replication(rank, **job)
            elif kind == "post":
                results[name] = _post_scenario(rank, 2, **job)
            elif kind == "time_weighted_l1":
                results[name] = _time_weighted_l1(rank, 2, **job)
            else:
                results[name] = _sp(rank, 2, **job)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pairs():
    """family -> (hp, JAX model, flax variables, port weights)."""
    from torch_port_pair import build_pair
    out = {}
    for family, cfg in FAMILIES.items():
        hp, jmodel, variables, model = build_pair(**cfg)
        out[family] = (hp, jmodel, variables,
                       {k: v.clone() for k, v in model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def sp_inputs():
    rs = np.random.RandomState(0)
    q, k, v, do = (rs.randn(*SP_SHAPE).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, np.asarray(SP_K_LEN, np.int32)


@pytest.fixture(scope="module")
def post_weights():
    """job -> the student's weights and codebook (the port's draw)."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_post_model)
    return {job: build_post_model(post_hparams(job), device="cpu",
                                  seed=1).state_dict()
            for job in POST}


@pytest.fixture(scope="module")
def twl1_inputs():
    """(pred, target, mask) of 4 rows whose halves mask different numbers
    of frames."""
    rs = np.random.RandomState(3)
    pred, target = (torch.from_numpy(rs.randn(4, 40, 16).astype(np.float32))
                    for _ in range(2))
    mask = torch.from_numpy(rs.rand(4, 40, 1) < np.array(
        [0.2, 0.3, 0.6, 0.7])[:, None, None])
    return pred, target, mask


@pytest.fixture(scope="module")
def two_ranks(pairs, sp_inputs, post_weights, twl1_inputs,
              tmp_path_factory):
    """Every job of the two gloo ranks in one spawn: rank -> name ->
    result."""
    batch = global_batch()
    jobs = {}
    for family in FAMILIES:
        jobs[family] = dict(kind="step", cfg=FAMILIES[family],
                            weights=pairs[family][3], batches=[batch])
    for variant, family in VARIANTS.items():
        jobs[variant] = dict(kind="step", cfg=FAMILIES[family],
                             weights=pairs[family][3], batches=[batch],
                             variant=variant)
    accumulation = [batch, global_batch(seed=1, lengths=(5, 12, 12, 7))]
    jobs["accumulation"] = dict(
        kind="step", cfg=FAMILIES["transformer"],
        weights=pairs["transformer"][3], accum_grad=2, batches=accumulation)
    jobs["resume"] = dict(
        kind="resume", cfg=FAMILIES["transformer"],
        weights=pairs["transformer"][3], batches=accumulation,
        save_dir=str(tmp_path_factory.mktemp("resume")))
    for remat in (False, True):
        jobs[f"dropout_remat_{remat}"] = dict(
            kind="step", cfg=dict(REMAT_DROPOUT, remat=remat),
            weights=pairs["transformer"][3], batches=[batch])
    jobs["dropout"] = dict(kind="dropout", cfg=FAMILIES["transformer"],
                           weights=pairs["transformer"][3])
    q, k, v, do, k_len = (torch.from_numpy(x) for x in sp_inputs)
    jobs["sp"] = dict(kind="sp", q=q, k=k, v=v, do=do, k_len=k_len)
    jobs["stop"] = dict(kind="stop")
    jobs["replication"] = dict(kind="replication",
                               cfg=FAMILIES["transformer"],
                               weights=pairs["transformer"][3])
    for job in POST:
        jobs[job] = dict(kind="post", job=job, weights=post_weights[job])
    jobs["post_vq_per_rank"] = dict(kind="post", job="post_vq",
                                    weights=post_weights["post_vq"],
                                    variant="per_rank_codebook")
    pred, target, mask = twl1_inputs
    jobs["time_weighted_l1"] = dict(kind="time_weighted_l1", pred=pred,
                                    target=target, mask=mask)
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    mp.spawn(_rank_main, args=(free_port(), jobs, out_dir), nprocs=2,
             join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


def single_process(pairs, family, batches, accum_grad=1):
    _, _, _, weights = pairs[family]
    hp, state = port_state(FAMILIES[family], weights, accum_grad)
    step = make_fastspeech2_train_step(hp, device="cpu")
    for batch in batches:
        state, logs = step(state, batch)
    return snapshot(state, logs)


def worst(got, ref, tol) -> float:
    """The largest error of ``got`` against ``ref`` over its tolerance:
    the logs relative, the gradients against tol x max(1, max|g|), the
    weights (where the reference's gradient is not rounding noise: Adam's
    first step moves those by any value in [-lr, lr]) and the BatchNorm
    statistics against atol + rtol x |ref|."""
    ratios = []
    for k, v in ref["logs"].items():
        ratios.append(abs(got["logs"][k] - v) / (tol["logs"] * abs(v)
                                                 + 1e-12))
    for name, g in ref["grads"].items():
        scale = max(1.0, float(g.abs().max()))
        ratios.append(float((got["grads"][name] - g).abs().max())
                      / (tol["grad"] * scale))
    for name, w in ref["weights"].items():
        if name.endswith("num_batches_tracked"):     # flax has no count
            continue
        w = w.float()
        ratio = ((got["weights"][name].float() - w).abs()
                 / (tol["atol"] + tol["rtol"] * w.abs()))
        if name in ref["grads"]:
            ratio = ratio[ref["grads"][name].abs() > 1e-7]
        if ratio.numel():
            ratios.append(float(ratio.max()))
    return max(ratios)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ddp_step_equals_single_process(two_ranks, pairs, family):
    ref = single_process(pairs, family, [global_batch()])
    for rank in range(2):
        assert worst(two_ranks[rank][family], ref, TIGHT) <= 1.0, rank
    # the ranks hold the same weights and BatchNorm statistics, moved once
    for name, w in two_ranks[0][family]["weights"].items():
        assert torch.equal(w, two_ranks[1][family]["weights"][name]), name
        if name.endswith("num_batches_tracked"):
            assert int(w) == int(ref["weights"][name]) == 1, name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_per_rank_reading_fails_the_check(two_ranks, pairs, variant):
    ref = single_process(pairs, VARIANTS[variant], [global_batch()])
    assert worst(two_ranks[0][variant], ref, TIGHT) >= 10.0
    assert worst(two_ranks[0][variant], ref, JAX_TOL) >= 10.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ddp_step_equals_jax_global_batch_step(two_ranks, pairs, family):
    import jax
    import jax.numpy as jnp

    from transformer_tts_tpu.config import HParams as JaxHParams
    from transformer_tts_tpu.train import schedule as jax_schedule
    from transformer_tts_tpu.train.trainer import (
        TrainState as JaxTrainState,
        make_fastspeech2_train_step as jax_train_step)
    from transformer_tts_tpu_torch.compat.from_jax import (
        state_dict_from_flax)
    hp, jmodel, variables, _ = pairs[family]
    jhp = JaxHParams(**dict(SMALL, **FAMILIES[family]))
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    new, jlogs = jax_train_step(jmodel, jhp, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in global_batch().items()},
        jax.random.PRNGKey(0))
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    ref = single_process(pairs, family, [global_batch()])
    ref["logs"] = {k: float(v) for k, v in jlogs.items()}
    ref["weights"] = state_dict_from_flax(host(new.params),
                                          host(new.batch_stats), hp)
    assert worst(two_ranks[0][family], ref, JAX_TOL) <= 1.0


def test_accumulation_syncs_the_last_micro_step(two_ranks, pairs):
    batches = [global_batch(), global_batch(seed=1, lengths=(5, 12, 12, 7))]
    ref = single_process(pairs, "transformer", batches, accum_grad=2)
    got = two_ranks[0]["accumulation"]
    # the update is the mean of the two micro-steps' global gradients,
    # and the logged norm is that mean's
    assert worst(got, ref, TIGHT) <= 1.0
    assert torch.equal(got["weights"]["encoder.layers.0.attn.q_linear.weight"],
                       two_ranks[1]["accumulation"]["weights"][
                           "encoder.layers.0.attn.q_linear.weight"])


def test_resume_mid_accumulation_equals_the_uninterrupted_run(two_ranks,
                                                               pairs):
    batches = [global_batch(), global_batch(seed=1, lengths=(5, 12, 12, 7))]
    ref = single_process(pairs, "transformer", batches, accum_grad=2)
    for rank in range(2):
        assert worst(two_ranks[rank]["resume"], ref, TIGHT) <= 1.0, rank
        assert worst(two_ranks[rank]["resume"],
                     two_ranks[rank]["accumulation"], TIGHT) <= 1.0, rank


def test_ddp_remat_step_equals_the_ddp_plain_step_with_dropout(two_ranks):
    # the checkpoint sits inside the module DDP wraps: the recompute does
    # not run DDP's forward again, draws the same masks on each rank and
    # leaves the global BatchNorm statistics moved once
    for rank in range(2):
        got = two_ranks[rank]["dropout_remat_True"]
        ref = two_ranks[rank]["dropout_remat_False"]
        assert worst(got, ref, TIGHT) <= 1.0, rank
        for name, value in got["weights"].items():
            if "running" in name or "num_batches" in name:
                assert torch.equal(value, ref["weights"][name]), name
    assert two_ranks[0]["dropout_remat_True"]["logs"] == (
        two_ranks[1]["dropout_remat_True"]["logs"])


def test_ranks_draw_different_dropout_streams(two_ranks):
    a, b = (two_ranks[r]["dropout"] for r in range(2))
    assert a["before"] == b["before"]        # the same initial draws
    assert a["seed"] != b["seed"]            # the kernels' dropout seeds
    assert not torch.equal(a["keep"], b["keep"])   # plain dropout masks


def test_sequence_parallel_attention_matches_reference(two_ranks,
                                                       sp_inputs):
    import jax
    import jax.numpy as jnp

    from transformer_tts_tpu.ops.flash_attention import reference_attention
    q, k, v, do, k_len = (jnp.asarray(x) for x in sp_inputs)
    ref, vjp = jax.vjp(lambda *a: reference_attention(*a, k_len), q, k, v)
    grads = dict(zip(("dq", "dk", "dv"), vjp(do)))
    for name, want in (("out", ref), *grads.items()):
        got = torch.cat([two_ranks[r]["sp"][name] for r in range(2)], dim=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_distribute_replicates_rank_0_and_checks_shapes(two_ranks):
    # rank 1's other weights are replaced by rank 0's; the shape check
    # refused two shapes on both ranks inside the job
    assert [two_ranks[r]["replication"]["rank0_weights"]
            for r in range(2)] == [True, True]


def test_ranks_agree_to_stop_when_one_is_signalled(two_ranks):
    assert [two_ranks[r]["stop"]["stop"] for r in range(2)] == [True, True]


def single_post(job, weights):
    from transformer_tts_tpu_torch.train import post_trainers
    hp, state = post_state(job, weights)
    step = post_trainers.make_meltomel_pregen_train_step(hp, device="cpu")
    out = {"skipped": []}
    for i, batch in enumerate(post_batches(job)):
        state, logs = step(state, batch)
        out["skipped"].append(bool(logs["skipped_nan"]))
        out["first" if i == 0 else "last"] = snapshot(state, logs)
    return out


CODEBOOK = ("quantize_lmfb.embed", "quantize_lmfb.cluster_size",
            "quantize_lmfb.embed_avg")


def test_ddp_vq_student_moves_one_codebook_by_the_global_batch(
        two_ranks, post_weights):
    # the first step's loss, gradients, weights and EMA codebook on every
    # rank equal one process's on the whole batch (past one update Adam's
    # normalised steps of rounding-noise gradients part any two sums);
    # after the second (DDP would refuse it had a parameter no gradient)
    # the ranks hold one codebook
    ref = single_post("post_vq", post_weights["post_vq"])["first"]
    for rank in range(2):
        assert worst(two_ranks[rank]["post_vq"]["first"], ref,
                     TIGHT) <= 1.0, rank
    for name in CODEBOOK:
        assert torch.equal(two_ranks[0]["post_vq"]["last"]["weights"][name],
                           two_ranks[1]["post_vq"]["last"]["weights"][name]
                           ), name
    # a codebook moved by each rank's batch alone parts the ranks
    per_rank = [two_ranks[r]["post_vq_per_rank"]["first"]["weights"]
                for r in range(2)]
    assert not torch.equal(per_rank[0]["quantize_lmfb.embed_avg"],
                           per_rank[1]["quantize_lmfb.embed_avg"])
    assert worst(two_ranks[0]["post_vq_per_rank"]["first"], ref,
                 TIGHT) >= 10.0


@pytest.mark.parametrize("job", ["post_nan", "post_nan_accum"])
def test_ddp_nan_guard_zeroes_every_rank_together(two_ranks, post_weights,
                                                  job):
    # the NaN lies in rank 1's half only: rank 0's own loss is finite, yet
    # both ranks skip, as JAX's global-batch test and one process on the
    # whole batch do, and hold the same finite weights; with accumulation
    # the skipped micro-steps' partial sums stay, averaged over the ranks
    ref = single_post(job, post_weights[job])
    want = [i in NAN_BATCHES for i in POST_BATCHES[job]]
    assert ref["skipped"] == want
    ref = dict(ref["last"], logs={})          # the loss is NaN
    for rank in range(2):
        got = two_ranks[rank][job]
        assert got["skipped"] == want, rank
        assert worst(got["last"], ref, TIGHT) <= 1.0, rank
        assert all(bool(torch.isfinite(w).all())
                   for w in got["last"]["weights"].values()), rank
    for name, w in two_ranks[0][job]["last"]["weights"].items():
        assert torch.equal(w, two_ranks[1][job]["last"]["weights"][name]
                           ), name


def test_time_weighted_l1_takes_the_group_counts(two_ranks, twl1_inputs):
    # the ranks' mean loss and their gradients, averaged as DDP averages
    # them, are the whole batch's
    from transformer_tts_tpu_torch.train import losses
    pred, target, mask = twl1_inputs
    pred = pred.clone().requires_grad_(True)
    whole = losses.time_weighted_l1(pred, target, mask, (0.7, 0.3), 16)
    whole.backward()
    got = [two_ranks[r]["time_weighted_l1"] for r in range(2)]
    np.testing.assert_allclose((got[0]["loss"] + got[1]["loss"]) / 2,
                               float(whole.detach()), rtol=1e-6)
    np.testing.assert_allclose(
        torch.cat([g["grad"] for g in got]).numpy() / 2,
        pred.grad.numpy(), rtol=1e-6, atol=1e-9)


# ---- the training CLI at two ranks -------------------------------------------

def _corpus(root, n=6, mel_dim=16, frames_per=3, ar=False, rs=None):
    rs = rs or np.random.RandomState(0)
    lines = []
    for i in range(n):
        t_text = rs.randint(4, 14)
        t_mel = t_text * frames_per
        base = os.path.join(str(root), f"utt{i}.npy")
        np.save(base, rs.randn(t_mel, mel_dim).astype(np.float32))
        if not ar:
            np.save(base.replace(".npy", "_alignment.npy"),
                    np.full((t_text,), frames_per, np.int32))
        np.save(base.replace(".npy", "_f0.npy"),
                (rs.rand(t_mel) * 300 + 60).astype(np.float32))
        np.save(base.replace(".npy", "_energy.npy"),
                (rs.rand(t_mel) * 100).astype(np.float32))
        ids = " ".join(str(x) for x in rs.randint(1, 40, t_text))
        lines.append(f"{base}|{ids}")
    script = os.path.join(str(root), "train.txt")
    with open(script, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return script


def _cli_rank(rank, port, hp_path):
    from transformer_tts_tpu_torch.cli import train as train_cli
    torch.set_num_threads(1)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu", "--multihost",
                    "--coordinator", f"127.0.0.1:{port}", "--num_processes",
                    "2", "--process_id", str(rank), "--max_steps", "3"])


def test_multihost_cli_at_two_ranks_then_synthesis(tmp_path):
    from transformer_tts_tpu_torch.cli import synthesize as synth_cli
    script = _corpus(tmp_path)
    save_dir = str(tmp_path / "ckpt")
    cfg = dict(SMALL, batch_size=2, max_epoch=2, save_per_epoch=1,
               warmup_step=10, train_script=script, save_dir=save_dir,
               text_buckets=(8, 16), length_buckets=(32, 64),
               num_workers=2)
    hp_path = str(tmp_path / "hparams.py")
    with open(hp_path, "w") as fh:
        fh.write("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    mp.spawn(_cli_rank, args=(free_port(), hp_path), nprocs=2, join=True)
    # 6 utterances in 3 batches of 2: 2 steps an epoch on each rank, the
    # third step in epoch 2; rank 0 alone logged and saved
    with open(os.path.join(save_dir, "logs", "train.jsonl")) as fh:
        steps = [json.loads(line)["step"] for line in fh]
    assert steps == [1, 2, 3]
    saved = torch.load(os.path.join(save_dir, "epoch_2", "model.pt"))
    assert not any(k.startswith("module.") for k in saved)
    out = tmp_path / "out"
    synth_cli.main(["--load_name", save_dir, "--test_script", script,
                    "--save", str(out), "--device", "cpu", "--max_frames",
                    "64"])
    mel = np.load(out / "0.npy")
    assert mel.shape[1] == 16 and np.isfinite(mel).all()


def test_init_distributed_needs_an_address_and_the_card(monkeypatch):
    from transformer_tts_tpu_torch.parallel import init_distributed
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(device="cpu")
    if not torch.cuda.is_available():
        # NCCL on the card or nothing: no quiet fall back to gloo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


# ---- the data layer ----------------------------------------------------------

DATA_CFG = dict(mel_dim=16, text_buckets=(8, 16), length_buckets=(16, 32, 64),
                batch_size=2)


def _normalised(root):
    rs = np.random.RandomState(7)
    np.save(os.path.join(str(root), "mean.npy"),
            rs.randn(16).astype(np.float32))
    np.save(os.path.join(str(root), "var.npy"),
            rs.uniform(0.5, 2, 16).astype(np.float32))
    return dict(mean_file=os.path.join(str(root), "mean.npy"),
                var_file=os.path.join(str(root), "var.npy"))


@pytest.mark.parametrize("total,shards", [(7, 2), (8, 3), (2, 4)])
def test_shard_batches_matches_jax(total, shards):
    from transformer_tts_tpu.data.sampler import (
        shard_batches as jax_shard_batches)
    from transformer_tts_tpu_torch.data.sampler import shard_batches
    batches = [[2 * i, 2 * i + 1] for i in range(total)]
    got = [shard_batches(batches, s, shards) for s in range(shards)]
    assert got == [jax_shard_batches(batches, s, shards)
                   for s in range(shards)]
    assert len({len(g) for g in got}) == 1
    assert {i for g in got for b in g for i in b} == {
        i for b in batches for i in b}


@pytest.mark.parametrize("num_workers", [1, 3])
def test_sharded_fixed_shape_loader_matches_jax(tmp_path, num_workers):
    from transformer_tts_tpu.config import HParams as JaxHParams
    from transformer_tts_tpu.data.dataset import TTSDataset as JaxDataset
    from transformer_tts_tpu.data.loader import DataLoader as JaxLoader
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    from transformer_tts_tpu_torch.data.loader import DataLoader
    script = _corpus(tmp_path, n=7)
    cfg = dict(DATA_CFG, **_normalised(tmp_path))
    for shard in range(2):
        ours = DataLoader(TTSDataset(script, HParams(**cfg)),
                          HParams(**cfg), num_workers=num_workers,
                          shard=shard, num_shards=2)
        ref = JaxLoader(JaxDataset(script, JaxHParams(**cfg)),
                        JaxHParams(**cfg), num_workers=num_workers,
                        shard=shard, num_shards=2)
        # a comprehension: list() would call the JAX loader's __len__,
        # which draws an epoch's shuffle of its own
        got, want = [b for b in ours], [b for b in ref]
        assert len(got) == len(want) == len(ours) == 2
        for a, b in zip(got, want):
            assert a["mel"].shape == (2, 64, 16)       # the top buckets
            assert a["text"].shape == (2, 16)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kw", [dict(pad_batch=True, batch_multiple=4),
                                dict(text_len=16, mel_len=64, batch=4)])
def test_collate_shapes_match_jax(tmp_path, kw):
    from transformer_tts_tpu.config import HParams as JaxHParams
    from transformer_tts_tpu.data.batching import collate as jax_collate
    from transformer_tts_tpu.data.dataset import TTSDataset as JaxDataset
    from transformer_tts_tpu_torch.data.batching import collate
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    script = _corpus(tmp_path, n=2)
    ours = collate([TTSDataset(script, HParams(**DATA_CFG))[i]
                    for i in range(2)], HParams(**DATA_CFG), **kw)
    ref = jax_collate([JaxDataset(script, JaxHParams(**DATA_CFG))[i]
                       for i in range(2)], JaxHParams(**DATA_CFG), **kw)
    assert ours["mel"].shape[0] == 4     # 2 rows padded to a multiple
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)


def test_native_reader_batch_equals_getitem(tmp_path):
    from transformer_tts_tpu_torch.data import native
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    script = _corpus(tmp_path, n=5)
    # a flattened mel: the reader refuses its width and __getitem__
    # reshapes it
    with open(script) as fh:
        first = fh.readline().split("|")[0]
    np.save(first, np.load(first).reshape(-1))
    for extra in ({}, _normalised(tmp_path)):
        ds = TTSDataset(script, HParams(**dict(DATA_CFG, **extra)))
        got = ds.load_batch_samples([0, 3, 1, 4, 2], n_threads=3)
        for i, sample in zip([0, 3, 1, 4, 2], got):
            want = ds[i]
            assert sorted(sample) == sorted(want)
            for key, value in want.items():
                np.testing.assert_array_equal(sample[key], value,
                                              err_msg=key)
    assert native.library_path().exists()
    _, lengths = native.load_mel_batch([first], 64, 16)
    assert lengths[0] < 0


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from transformer_tts_tpu_torch.data import native
    broken = tmp_path / "tts_data.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build"):
        native.load_library()


# ---- RAdam -------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,degenerated_to_sgd",
                         [(0.0, True), (0.01, True), (0.01, False)])
def test_radam_matches_reference_radam_step_for_step(weight_decay,
                                                     degenerated_to_sgd):
    import jax.numpy as jnp

    from transformer_tts_tpu.train.schedule import reference_radam
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 5), "b": (7,)}
    params = {k: jnp.asarray(rs.randn(*s).astype(np.float32))
              for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.tensor(np.asarray(v)))
               for k, v in params.items()}
    tx = reference_radam(1e-3, weight_decay=weight_decay,
                         degenerated_to_sgd=degenerated_to_sgd)
    opt = schedule.ReferenceRAdam(tparams.values(), lr=1e-3,
                                  weight_decay=weight_decay,
                                  degenerated_to_sgd=degenerated_to_sgd)
    state = tx.init(params)
    moved = []
    for step in range(10):        # N_sma < 5 (degenerate) up to step 5
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = {k: params[k] + updates[k] for k in params}
        before = tparams["a"].detach().clone()
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        moved.append(not torch.equal(before, tparams["a"].detach()))
        for k in shapes:
            np.testing.assert_array_equal(tparams[k].detach().numpy(),
                                          np.asarray(params[k]),
                                          err_msg=f"{k} step {step}")
    assert moved == [degenerated_to_sgd] * 5 + [True] * 5


# ---- remat -------------------------------------------------------------------

def test_remat_step_equals_the_plain_step_with_dropout(pairs):
    # dropout on (REMAT_DROPOUT) and the postnet's BatchNorm, whose
    # statistics move once
    _, _, _, weights = pairs["transformer"]
    batch = global_batch()
    calls = []
    runs = {}
    for remat in (False, True):
        cfg = dict(REMAT_DROPOUT, remat=remat)
        hp, state = port_state(cfg, weights)
        torch.manual_seed(3)
        step = make_fastspeech2_train_step(hp, device="cpu")
        norms = [m for m in state.model.modules()
                 if type(m).__name__ == "FlaxBatchNorm1d"]
        real = type(norms[0]).forward

        def counting(self, x, real=real):
            calls.append(remat)
            return real(self, x)

        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setattr(type(norms[0]), "forward", counting)
            state, logs = step(state, batch)
        runs[remat] = snapshot(state, logs)
    # the remat step ran the postnet's norms twice (forward, recompute)
    assert calls.count(True) == 2 * calls.count(False) > 0
    plain, remat = runs[False], runs[True]
    assert worst(remat, plain, TIGHT) <= 1.0
    for name, value in remat["weights"].items():
        if "running" in name or "num_batches" in name:
            assert torch.equal(value, plain["weights"][name]), name


# ---- every family's step gives every parameter a gradient --------------------

GRAD_FAMILIES = {
    "fastspeech2_ctc_xvector": (dict(CTC_training=True, is_multi_speaker=True,
                                     spk_emb_type="x_vector",
                                     spk_emb_dim=512), "fs2"),
    "conformer_speakers": (dict(encoder_type="conformer",
                                decoder_type="conformer",
                                is_multi_speaker=True,
                                spk_emb_type="speaker_id", spk_emb_dim=8,
                                accent_emb=True, use_hop=True), "fs2"),
    "use_sq_vae": (dict(use_sq_vae=True), "fs2"),
    "sq_speakers": (dict(model="SQFastSpeech2", is_multi_speaker=True,
                         spk_emb_type="speaker_id", spk_emb_dim=8,
                         accent_emb=True), "sq"),
    "ar_guided": (dict(model="Transformer", reduction_rate=2,
                       guided_attention_weight=1.0), "ar"),
    "gst_speakers": (dict(model="Transformer", reduction_rate=2, gst=True,
                          is_multi_speaker=True, spk_emb_type="speaker_id",
                          spk_emb_dim=8), "ar"),
    "tacotron2": (dict(model="Transformer", reduction_rate=2,
                       decoder_type="tacotron2"), "ar"),
}


def _family_batch(hp, kind, rs):
    b, l = 2, 8
    if kind == "ar":
        t = 2 * 20
    else:
        t = 64
    lengths = (8, 5)
    text = rs.randint(1, 40, (b, l)).astype(np.int32)
    text *= np.arange(l)[None] < np.asarray(lengths)[:, None]
    pos_text = np.where(text != 0, np.arange(1, l + 1)[None],
                        0).astype(np.int32)
    dur = rs.randint(2, 5, (b, l)).astype(np.int32) * (text != 0)
    frames = dur.sum(1) if kind != "ar" else np.array([t, 24])
    pos_mel = np.where(np.arange(t)[None] < frames[:, None],
                       np.arange(1, t + 1)[None], 0).astype(np.int32)
    mel = rs.randn(b, t, 16).astype(np.float32)
    batch = dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                 alignment=dur, f0=rs.uniform(60, 800, (b, t)).astype(
                     np.float32),
                 energy=rs.uniform(0, 300, (b, t)).astype(np.float32),
                 stop_token=(pos_mel == 0).astype(np.float32))
    if hp.is_multi_speaker:
        batch["spk_emb"] = (np.arange(b, dtype=np.int32)
                            if hp.spk_emb_type == "speaker_id"
                            else rs.randn(b, 512).astype(np.float32))
    if hp.accent_emb:
        batch["accent"] = (text > 0).astype(np.int32)
    if hp.use_hop:
        batch["hop_size"] = np.ones(b, np.int32)
    return batch


@pytest.mark.parametrize("family", list(GRAD_FAMILIES))
def test_every_parameter_gets_a_gradient(family, monkeypatch):
    # what lets distribute() leave DDP's find_unused_parameters off
    from transformer_tts_tpu_torch.train import trainer
    extra, kind = GRAD_FAMILIES[family]
    hp = HParams(**dict(SMALL, **extra))
    init, make = {
        "fs2": (trainer.init_fastspeech2_state,
                trainer.make_fastspeech2_train_step),
        "ar": (trainer.init_transformer_state,
               trainer.make_transformer_train_step),
        "sq": (trainer.init_sq_fastspeech2_state,
               trainer.make_sq_fastspeech2_train_step)}[kind]
    state = init(hp, device="cpu")
    missing = []
    real = schedule.Optimizer._grads

    def recording(self):
        names = {id(p): n for n, p in state.model.named_parameters()}
        missing.extend(names[id(p)] for p in self.params if p.grad is None)
        return real(self)

    monkeypatch.setattr(schedule.Optimizer, "_grads", recording)
    batch = _family_batch(hp, kind, np.random.RandomState(0))
    make(hp, device="cpu")(state, batch)
    assert missing == []


# ---- evaluation and duration tools -------------------------------------------

def test_mcd_and_mel_l1_match_jax():
    from transformer_tts_tpu import eval as jax_eval
    from transformer_tts_tpu_torch import eval as port_eval
    rs = np.random.RandomState(0)
    ref = rs.randn(50, 20) - 2.0
    same = ref + 0.1 * rs.randn(50, 20)
    longer = rs.randn(61, 20) - 2.0
    for gen in (same, longer):
        for kw in ({}, {"use_dtw": True}, {"n_mfc": 8}):
            assert port_eval.mcd(ref, gen, **kw) == jax_eval.mcd(ref, gen,
                                                                 **kw)
        assert port_eval.mel_l1(ref, gen) == jax_eval.mel_l1(ref, gen)
    cost = rs.rand(9, 13)
    for a, b in zip(port_eval.dtw_path(cost), jax_eval.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        port_eval.mcd(ref[:0], gen)


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    from transformer_tts_tpu.cli import evaluate as jax_cli
    from transformer_tts_tpu_torch.cli import evaluate as port_cli
    rs = np.random.RandomState(1)
    lines = []
    (tmp_path / "gen").mkdir()
    for i, (t_ref, t_gen) in enumerate(((40, 40), (30, 37))):
        ref = tmp_path / f"ref{i}.npy"
        np.save(ref, rs.randn(t_ref, 16).astype(np.float32))
        np.save(tmp_path / "gen" / f"{i}.npy",
                rs.randn(t_gen, 16).astype(np.float32))
        lines.append(f"{ref}|1 2 3")
    (tmp_path / "test.txt").write_text("\n".join(lines) + "\n")
    args = ["--ref_script", str(tmp_path / "test.txt"), "--gen_dir",
            str(tmp_path / "gen")]
    assert port_cli.main(args) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    assert ours == capsys.readouterr().out and "mcd=" in ours
    pair = [str(tmp_path / "ref0.npy"), str(tmp_path / "gen" / "1.npy")]
    port_cli.main(["--pairs", *pair, "--dtw"])
    ours = capsys.readouterr().out
    jax_cli.main(["--pairs", *pair, "--dtw"])
    assert ours == capsys.readouterr().out


def _attention(rs, layers=2, heads=2, t_q=20, n=7):
    a = rs.rand(layers, heads, t_q, n) ** 4
    # one focused, near-diagonal head
    diag = np.zeros((t_q, n))
    diag[np.arange(t_q), np.minimum(np.arange(t_q) * n // t_q, n - 1)] = 5.0
    a[1, 0] += diag
    return a / a.sum(-1, keepdims=True)


@pytest.mark.parametrize("n_frames,r", [(40, 2), (37, 2), (9, 1)])
def test_duration_tools_match_jax(n_frames, r):
    from transformer_tts_tpu.cli import extract_durations as jax_ed
    from transformer_tts_tpu_torch.cli import extract_durations as port_ed
    attn = _attention(np.random.RandomState(n_frames))
    n = attn.shape[-1]
    d = port_ed.durations_from_attention(attn, n, n_frames, r)
    np.testing.assert_array_equal(
        d, jax_ed.durations_from_attention(attn, n, n_frames, r))
    assert d.sum() == n_frames
    got, want = (m.mas_durations(attn, n, n_frames, r)
                 for m in (port_ed, jax_ed))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[0].sum() == n_frames
    assert (port_ed.attention_quality(attn, n, n_frames, r, head=got[1])
            == jax_ed.attention_quality(attn, n, n_frames, r, head=got[1]))


def test_extract_durations_cli_matches_jax(tmp_path):
    from torch_port_pair import (
        AR, build_ar_pair, write_engine_checkpoints)
    from transformer_tts_tpu.cli import extract_durations as jax_cli
    from transformer_tts_tpu_torch.cli import extract_durations as port_cli
    script = _corpus(tmp_path, n=3, frames_per=5, ar=True)
    _, _, variables, model = build_ar_pair(0)
    cfg = dict(SMALL, **AR, train_script=script, text_buckets=(16,),
               length_buckets=(128,))
    jax_dir, port_dir = write_engine_checkpoints(tmp_path, cfg, variables,
                                                 model)
    outs = {}
    for name, cli, load in (("jax", jax_cli, jax_dir),
                            ("port", port_cli, port_dir)):
        out = tmp_path / f"durations_{name}"
        argv = ["--load_name", load, "--out_dir", str(out), "--stats_file",
                str(tmp_path / f"{name}.json")]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = out
    for i in range(3):
        got = np.load(outs["port"] / f"utt{i}_alignment.npy")
        np.testing.assert_array_equal(
            got, np.load(outs["jax"] / f"utt{i}_alignment.npy"))
        assert got.sum() == np.load(tmp_path / f"utt{i}.npy").shape[0]
    with open(tmp_path / "port.json") as fh:
        ours = json.load(fh)
    with open(tmp_path / "jax.json") as fh:
        ref = json.load(fh)
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, float):
            np.testing.assert_allclose(ours[key], value, rtol=1e-5)
        else:
            assert ours[key] == value


def test_spec_augment_matches_jax():
    from transformer_tts_tpu import utils as jax_utils
    from transformer_tts_tpu_torch import utils as port_utils
    spec = np.random.RandomState(0).randn(3, 80, 20).astype(np.float32)
    for seed in range(3):
        got = port_utils.spec_augment(spec, T=30, F=8, num_T=2, num_F=2,
                                      rng=np.random.RandomState(seed))
        want = jax_utils.spec_augment(spec, T=30, F=8, num_T=2, num_F=2,
                                      rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any() and not (spec == 0).any()
    for fn in ("freq_mask", "time_mask"):
        np.testing.assert_array_equal(
            getattr(port_utils, fn)(spec[0], 10, 2,
                                    rng=np.random.RandomState(5)),
            getattr(jax_utils, fn)(spec[0], 10, 2,
                                   rng=np.random.RandomState(5)))


def test_plot_mel_and_alignment_writes_an_image(tmp_path):
    from transformer_tts_tpu_torch.utils import plot_mel_and_alignment
    path = plot_mel_and_alignment(np.random.RandomState(0).randn(30, 16),
                                  np.array([5, 10, 15]),
                                  str(tmp_path / "a.png"),
                                  text_labels=["a", "b", "c"])
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
