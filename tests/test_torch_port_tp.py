"""The port's tensor parallelism and meshes against a single process and
the JAX package, on the CPU.

Two gloo ranks (one spawn for the module) split the attention heads and
FFN channels of a small model over a ``model`` group of 2
(``parallel.tp.tensor_parallel``) and take train steps of the transformer
FastSpeech 2, the conformer FastSpeech 2 and the AR Transformer-TTS on the
whole batch: the logged terms, the gathered gradients and updated weights
and the BatchNorm statistics equal one process's step at fp32 tightness
and JAX's jitted step at tests/test_torch_port_train.py's tolerances. At
dropout 0.1 over 256 frames (the decoder on the kernel path with the
global head in the dropout hash, the encoder on the masked path keeping
its heads' slice of torch's mask) the split step still equals one
process's. Four gloo ranks (a second spawn) run the flagship on the
(data 2, model 2) mesh and the (dcn 2, data 2) multislice mesh, whose DDP
hook carries half the gradient's elements across slices. Beside them:
the keep mask at a head offset against JAX's ``_keep_mask`` at the global
batch-head and the whole mask's slice, the kernels' plain versions at a
head offset against the whole tensor's, ``param_shardings`` and
``gather_state_dict``, a split checkpoint against the unsharded run's and
its resume, and ``dryrun_multichip(4, "cpu")``.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_port_parallel import (JAX_TOL, TIGHT, free_port,
                                      global_batch, worst)
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.ops import flash_attention as fa
from transformer_tts_tpu_torch.ops import flash_relpos as fr
from transformer_tts_tpu_torch.train import schedule
from transformer_tts_tpu_torch.train import trainer as tr

# d 64, 2 + 2 layers, 4 heads: 2 heads (and half the FFN channels) a rank
TP = dict(vocab_size=40, mel_dim=16, d_model_encoder=64, d_model_decoder=64,
          n_layer_encoder=2, n_layer_decoder=2, n_head_encoder=4,
          n_head_decoder=4, ff_conv_kernel_size_encoder=5,
          ff_conv_kernel_size_decoder=1, amp=False, dropout=0.0,
          dropout_postnet=0.0, dropout_variance_adaptor=0.0, warmup_step=10)
FAMILIES = {
    "transformer": {},
    "conformer": dict(encoder_type="conformer", decoder_type="conformer"),
    "ar": dict(model="Transformer", reduction_rate=2, dropout_prenet=0.0),
}
DROPOUT = dict(dropout=0.1, dropout_postnet=0.1,
               dropout_variance_adaptor=0.1)
# the AR step with the guided-attention loss: every attention's maps,
# gathered over the group, on the masked path
GUIDED = dict(guided_attention_weight=2.0)
# the meshes of the four ranks: (mesh dims, sizes)
MESHES = {"data2_model2": ("data", (2, 2)),
          "dcn2_data2": ("dcn", (2, 2, 1))}
AR_FRAMES = (500, 301)          # T_dec 259 >= FLASH_MIN_KEY_LEN: K3's path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small models: one intra-op thread each, so the module's tests (and
    the spawned ranks) do not spin against the other test workers for the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hparams(family, **kw):
    return HParams(**dict(TP, **FAMILIES[family], **kw))


def ar_batch(seed=0, b=2, l=12, t=520, mel_dim=16, frames=AR_FRAMES):
    """A collated AR batch (the go frame first, lengths rounded up to r,
    stop_token 1.0 past each row's frames)."""
    rs = np.random.RandomState(seed)
    lengths = (l, l - 3)
    pos_text = np.where(np.arange(l)[None] < np.asarray(lengths)[:, None],
                        np.arange(1, l + 1)[None], 0).astype(np.int32)
    text = np.where(pos_text > 0, rs.randint(1, 40, (b, l)),
                    0).astype(np.int32)
    mel = np.full((b, t, mel_dim), -5.0, np.float32)
    stop = np.ones((b, t), np.float32)
    for i, n in enumerate(frames):
        mel[i, 0] = 0.0
        mel[i, 1:n + 1] = rs.randn(n, mel_dim)
        stop[i, :n + 1] = 0.0
    ends = np.asarray([-(-(n + 1) // 2) * 2 for n in frames])[:, None]
    pos_mel = np.where(np.arange(t)[None] < ends, np.arange(1, t + 1)[None],
                       0).astype(np.int32)
    return dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                stop_token=stop)


def batch_of(family, seed=0):
    if family == "ar":
        return ar_batch(seed)
    return global_batch(seed=seed, t=256)


def step_of(hp):
    if hp.model == "Transformer":
        return tr.make_transformer_train_step(hp, device="cpu")
    return tr.make_fastspeech2_train_step(hp, device="cpu")


def port_state(hp, weights):
    """A state on ``weights``, torch's and its own generators seeded
    alike on every rank."""
    from transformer_tts_tpu_torch.models import build_model
    torch.manual_seed(0)
    model = build_model(hp, device="cpu")
    model.load_state_dict(weights)
    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return tr.TrainState(model, opt, torch.Generator().manual_seed(0))


def port_weights(hp):
    from transformer_tts_tpu_torch.models import build_model
    return {k: v.clone() for k, v in
            build_model(hp, device="cpu", seed=3).state_dict().items()}


def gathered(state, logs):
    """The logs, the gradients and the weights in the unsharded names and
    shapes (a collective over the state's model group)."""
    from transformer_tts_tpu_torch.parallel import tp
    group = state.model_group
    grads = {}
    for name, p in state.model.named_parameters():
        shard = getattr(p, "tp_shard", None)
        g = p.grad.detach()
        grads[name] = g if shard is None else tp._gather(g, shard, group)
    weights = (tp.gather_state_dict(state.model, group) if group is not None
               else state.model.state_dict())
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": grads,
            "weights": {k: v.detach().clone() for k, v in weights.items()}}


def single(hp, weights, batches):
    state = port_state(hp, weights)
    tr.fold_rank(state, 0)
    step = step_of(hp)
    for batch in batches:
        state, logs = step(state, batch)
    return gathered(state, logs), state


# ---- the ranks --------------------------------------------------------------

def _mesh(kind, sizes):
    from transformer_tts_tpu_torch.parallel import (make_mesh,
                                                    make_multislice_mesh)
    if kind == "dcn":
        return make_multislice_mesh(sizes[0], sizes[2], device="cpu")
    return make_mesh(*sizes, device="cpu")


def _tp_step(family, weights, extra=None, mesh=("data", (1, 2))):
    """One train step of ``family`` on ``mesh``, each rank on its data
    coordinate's rows of the batch."""
    from transformer_tts_tpu_torch.parallel import (
        batch_rows, gather_state_dict, param_shardings)
    hp = hparams(family, **(extra or {}))
    state = port_state(hp, weights)
    mesh = _mesh(*mesh)
    state = tr.distribute(state, "cpu", mesh)
    initial = (gather_state_dict(state.model, state.model_group)
               if state.model_group is not None else state.model.state_dict())
    same = all(torch.equal(v, weights[k]) for k, v in initial.items())
    batch = batch_of(family)
    rows_of = batch_rows(mesh, batch["text"].shape[0])
    state, logs = step_of(hp)(state, {k: v[rows_of]
                                      for k, v in batch.items()})
    out = gathered(state, logs)
    out["shardings"] = param_shardings(state.model)
    out["local"] = {n: tuple(p.shape)
                    for n, p in state.model.named_parameters()}
    out["stats"] = {k: v.clone() for k, v in state.model.state_dict().items()
                    if "running" in k}
    out["gathered_initial"] = same
    hook = getattr(state.ddp, "comm_state", None)
    out["hook"] = None if hook is None else dict(vars(hook), data=None,
                                                 dcn=None)
    return out


def _checkpoint(weights, save_dir):
    """One split step, saved; a fresh state resumed from it (restored
    whole, then split), a second step; and the save restored into a split
    state."""
    from transformer_tts_tpu_torch.parallel import tp
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    hp = hparams("transformer")
    batches = [global_batch(t=256), global_batch(seed=1, t=256)]
    mesh = _mesh("data", (1, 2))
    state = tr.distribute(port_state(hp, weights), "cpu", mesh)
    step = step_of(hp)
    state, _ = step(state, batches[0])
    ckpt.save_train_checkpoint(save_dir, state, 1, hp)
    resumed, epoch = ckpt.restore_train_checkpoint(
        save_dir, port_state(hp, weights))
    assert epoch == 1
    resumed = tr.distribute(resumed, "cpu", mesh)
    resumed, logs = step(resumed, batches[1])
    split = tr.distribute(port_state(hp, weights), "cpu", mesh)
    split, _ = ckpt.restore_train_checkpoint(save_dir, split)
    same = all(torch.equal(a, b) for a, b in zip(
        tp.gather_state_dict(split.model, split.model_group).values(),
        tp.gather_state_dict(state.model, state.model_group).values()))
    state, through = step(state, batches[1])
    return {"resumed": gathered(resumed, logs),
            "uninterrupted": gathered(state, through),
            "split_restore": same, "save_dir": save_dir}


def _rank_main(rank, world, port, jobs, out_dir):
    from transformer_tts_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        results = {}
        for name, job in jobs.items():
            kind = job.pop("kind")
            if kind == "checkpoint":
                results[name] = _checkpoint(**job)
            else:
                results[name] = _tp_step(**job)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world, jobs, out_dir):
    mp.spawn(_rank_main, args=(world, free_port(), jobs, out_dir),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def pairs():
    """family -> (hp, JAX model, flax variables, port weights)."""
    from torch_port_pair import build_ar_pair, build_pair
    out = {}
    for family, cfg in FAMILIES.items():
        if family == "ar":          # build_ar_pair adds FAMILIES["ar"]
            hp, jmodel, variables, model = build_ar_pair(**TP)
        else:
            hp, jmodel, variables, model = build_pair(**dict(TP, **cfg))
        out[family] = (hp, jmodel, variables,
                       {k: v.clone() for k, v in model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def dropout_weights():
    return port_weights(hparams("transformer", **DROPOUT))


@pytest.fixture(scope="module")
def two_ranks(pairs, dropout_weights, tmp_path_factory):
    jobs = {family: dict(kind="step", family=family,
                         weights=pairs[family][3]) for family in FAMILIES}
    jobs["dropout"] = dict(kind="step", family="transformer",
                           weights=dropout_weights, extra=DROPOUT)
    jobs["guided"] = dict(kind="step", family="ar", weights=pairs["ar"][3],
                          extra=GUIDED)
    jobs["checkpoint"] = dict(kind="checkpoint",
                              weights=pairs["transformer"][3],
                              save_dir=str(tmp_path_factory.mktemp("tp")))
    return spawn(2, jobs, str(tmp_path_factory.mktemp("ranks2")))


@pytest.fixture(scope="module")
def four_ranks(pairs, tmp_path_factory):
    jobs = {name: dict(kind="step", family="transformer",
                       weights=pairs["transformer"][3], mesh=mesh)
            for name, mesh in MESHES.items()}
    return spawn(4, jobs, str(tmp_path_factory.mktemp("ranks4")))


@pytest.fixture(scope="module")
def jax_steps(pairs):
    """family -> JAX's jitted step on the whole batch: (logs, the updated
    weights in the port's names)."""
    import jax
    import jax.numpy as jnp

    from transformer_tts_tpu.config import HParams as JaxHParams
    from transformer_tts_tpu.train import schedule as jax_schedule
    from transformer_tts_tpu.train import trainer as jtr
    from transformer_tts_tpu_torch.compat.from_jax import (
        state_dict_from_flax)
    out = {}
    for family in FAMILIES:
        hp, jmodel, variables, _ = pairs[family]
        jhp = JaxHParams(**dict(TP, **FAMILIES[family]))
        tx = jax_schedule.build_optimizer(
            jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
            jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
        state = jtr.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            opt_state=tx.init(variables["params"]),
            batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
        make = (jtr.make_transformer_train_step if family == "ar"
                else jtr.make_fastspeech2_train_step)
        new, logs = make(jmodel, jhp, donate=False)(
            state, {k: jnp.asarray(v) for k, v in batch_of(family).items()},
            jax.random.PRNGKey(0))
        host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
        out[family] = ({k: float(v) for k, v in logs.items()},
                       state_dict_from_flax(host(new.params),
                                            host(new.batch_stats), hp))
    return out


def against_jax(ref, jax_step):
    """``ref`` (one process's step) with JAX's logs and weights."""
    logs, weights = jax_step
    return dict(ref, logs=logs, weights=weights)


# ---- the tests --------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1])
def test_keep_mask_at_a_head_offset_is_the_global_slice(seed, rate):
    import jax.numpy as jnp

    from transformer_tts_tpu.ops.flash_attention import _keep_mask
    b, heads, local, t_q, t_k = 3, 4, 2, 24, 40
    whole = fa._full_keep_mask(b, heads, t_q, t_k, seed, rate, "cpu")
    for offset in (0, 2):
        part = fa._full_keep_mask(b, local, t_q, t_k, seed, rate, "cpu",
                                  offset, heads)
        assert torch.equal(part, whole[:, offset:offset + local])
        for i in range(b):
            for h in range(local):
                ref = np.asarray(_keep_mask(
                    jnp.int32(seed), jnp.int32(i * heads + offset + h),
                    jnp.int32(0), jnp.int32(0), (t_q, t_k), rate))
                np.testing.assert_array_equal(
                    part[i, h].numpy().view(np.uint32), ref.view(np.uint32))
    # the default is the tensor's own batch-heads
    assert torch.equal(fa._full_keep_mask(b, local, t_q, t_k, seed, rate,
                                          "cpu"),
                       fa._full_keep_mask(b, local, t_q, t_k, seed, rate,
                                          "cpu", 0, local))
    with pytest.raises(ValueError, match="not heads of"):
        fa.hash_heads(b, local, 3, heads)


def _attention_inputs(relative, seed=0):
    rs = np.random.RandomState(seed)
    b, h, t, d = 2, 4, 64, 16
    names = ("q_u", "q_v", "k", "v") if relative else ("q", "k", "v")
    xs = {n: torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32))
          for n in names}
    if relative:
        xs["p"] = torch.from_numpy(rs.randn(h, t, d).astype(np.float32))
    k_len = torch.tensor([t, 40], dtype=torch.int32)
    do = torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32))
    return xs, k_len, do


@pytest.mark.parametrize("relative", [False, True], ids=["K1-K2", "K4-K5"])
def test_kernels_at_a_head_offset_are_the_whole_tensors_slice(relative):
    """The plain versions through the ops (the CPU's kernels): the heads
    [2, 4) of 4 with head_offset 2 give the whole call's slice of o and of
    every gradient, dropout on; at offset 0 they do not."""
    xs, k_len, do = _attention_inputs(relative)
    kw = dict(dropout_rate=0.3, dropout_seed=11)
    fn = fr.flash_relpos_attention if relative else fa.flash_attention

    def run(tensors, grad, **extra):
        leaves = {n: x.clone().requires_grad_() for n, x in tensors.items()}
        o, _ = fn(*leaves.values(), k_len, **kw, **extra)
        o.backward(grad)
        return o.detach(), {n: x.grad for n, x in leaves.items()}

    whole, whole_grads = run(xs, do)
    part = {n: x[:, 2:] if x.dim() == 4 else x[2:] for n, x in xs.items()}
    got, grads = run(part, do[:, 2:], head_offset=2, heads_total=4)
    torch.testing.assert_close(got, whole[:, 2:], rtol=0, atol=0)
    for name, g in grads.items():
        want = whole_grads[name]
        want = want[:, 2:] if want.dim() == 4 else want[2:]
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6,
                                   msg=name)
    wrong, _ = run(part, do[:, 2:])          # the local batch-heads' masks
    assert not torch.equal(wrong, whole[:, 2:])


def test_split_blocks_and_gathered_state(two_ranks, pairs):
    weights = pairs["transformer"][3]
    got = two_ranks[0]["transformer"]
    split = {n: d for n, d in got["shardings"].items() if d is not None}
    for name, dim in split.items():
        whole = weights[name].shape
        local = got["local"][name]
        front = whole[dim] - 64 if name.endswith("out.weight") else 0
        assert local[dim] - front == (whole[dim] - front) // 2, name
    for block in ("attn.q_linear.weight", "attn.out.weight",
                  "ff.f_1.weight", "ff.f_2.weight", "ff.f_1.bias"):
        assert any(n.endswith(block) for n in split), block
    assert not any(n.endswith(("ff.f_2.bias", "attn.out.bias", "norm_1"
                               ".weight")) for n in split)
    # every rank gathers the same unsharded state; its names and shapes are
    # the model's
    for rank in range(2):
        state = two_ranks[rank]["transformer"]["weights"]
        assert sorted(state) == sorted(weights)
        for name, value in state.items():
            assert value.shape == weights[name].shape, name
            assert torch.equal(value,
                               two_ranks[0]["transformer"]["weights"][name])


def test_gather_state_dict_is_the_unsharded_model_bit_for_bit(two_ranks,
                                                              four_ranks):
    # gathered right after the split, before any step: every rank, every
    # family and mesh
    for ranks in (two_ranks, four_ranks):
        for rank in ranks:
            for name, got in rank.items():
                if "gathered_initial" in got:
                    assert got["gathered_initial"], name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_step_equals_single_process_and_jax(two_ranks, pairs, jax_steps,
                                               family):
    hp, _, _, weights = pairs[family]
    ref, _ = single(hparams(family), weights, [batch_of(family)])
    for rank in range(2):
        assert worst(two_ranks[rank][family], ref, TIGHT) <= 1.0, rank
    got = two_ranks[0][family]
    logs = jax_steps[family][0]
    np.testing.assert_allclose(got["logs"]["loss_total"],
                               logs["loss_total"], rtol=1e-5)
    np.testing.assert_allclose(got["logs"]["grad_norm"], logs["grad_norm"],
                               rtol=1e-4)
    assert worst(got, against_jax(ref, jax_steps[family]), JAX_TOL) <= 1.0


def test_tp_step_with_dropout_equals_single_process(two_ranks,
                                                    dropout_weights):
    hp = hparams("transformer", **DROPOUT)
    ref, _ = single(hp, dropout_weights, [batch_of("transformer")])
    for rank in range(2):
        assert worst(two_ranks[rank]["dropout"], ref, TIGHT) <= 1.0, rank


def test_tp_guided_attention_step_equals_single_process(two_ranks, pairs):
    ref, _ = single(hparams("ar", **GUIDED), pairs["ar"][3],
                    [batch_of("ar")])
    assert ref["logs"]["loss_guided_attention"] > 0
    for rank in range(2):
        assert worst(two_ranks[rank]["guided"], ref, TIGHT) <= 1.0, rank


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_equals_single_process_and_jax(four_ranks, pairs,
                                                 jax_steps, mesh):
    ref, _ = single(hparams("transformer"), pairs["transformer"][3],
                    [batch_of("transformer")])
    for rank in range(4):
        got = four_ranks[rank][mesh]
        assert worst(got, ref, TIGHT) <= 1.0, rank
        for name, value in got["stats"].items():
            assert torch.equal(value, four_ranks[0][mesh]["stats"][name])
    assert worst(four_ranks[0][mesh],
                 against_jax(ref, jax_steps["transformer"]),
                 JAX_TOL) <= 1.0
    hook = four_ranks[0][mesh]["hook"]
    if mesh.startswith("dcn"):
        # the slices' all-reduce carried the data group's 1/2 shard of
        # each bucket (one padding element at most per bucket)
        assert 0 <= 2 * hook["dcn_elements"] - hook["elements"] \
            <= hook["buckets"]
    else:
        assert hook is None


def test_tp_checkpoint_equals_the_unsharded_run_and_resumes(two_ranks,
                                                            pairs, tmp_path):
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    hp = hparams("transformer")
    weights = pairs["transformer"][3]
    batches = [global_batch(t=256), global_batch(seed=1, t=256)]
    first, state = single(hp, weights, batches[:1])
    ckpt.save_train_checkpoint(str(tmp_path), state, 1, hp)
    split_dir = two_ranks[0]["checkpoint"]["save_dir"]
    for name in (ckpt.CHECKPOINT_NAME, ckpt.TRAIN_STATE_NAME):
        got = torch.load(os.path.join(ckpt.epoch_dir(split_dir, 1), name),
                         weights_only=False)
        want = torch.load(os.path.join(ckpt.epoch_dir(str(tmp_path), 1),
                                       name), weights_only=False)
        if name == ckpt.TRAIN_STATE_NAME:
            assert got["step"] == want["step"] == 1
            got, want = (x["optimizer"]["inner"]["state"] for x in
                         (got, want))
            got = {f"{i}.{k}": v for i, s in got.items()
                   for k, v in s.items()}
            want = {f"{i}.{k}": v for i, s in want.items()
                    for k, v in s.items()}
        assert sorted(got) == sorted(want), name
        for key, value in want.items():
            assert got[key].shape == value.shape, key
        if name == ckpt.CHECKPOINT_NAME:
            # the weights where the gradient is not rounding noise
            assert worst(dict(first, weights=got), dict(first, weights=want),
                         TIGHT) <= 1.0
        else:
            for key, value in want.items():
                torch.testing.assert_close(got[key], value, rtol=2e-5,
                                           atol=1e-6, msg=key)
    # the resume re-splits the whole checkpoint: its second step is the
    # uninterrupted split run's, bit for bit; so is a restore into a state
    # split before it
    for rank in range(2):
        out = two_ranks[rank]["checkpoint"]
        assert out["resumed"]["logs"] == out["uninterrupted"]["logs"], rank
        for key, value in out["uninterrupted"]["weights"].items():
            assert torch.equal(out["resumed"]["weights"][key], value), key
        assert out["split_restore"], rank


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    from transformer_tts_tpu_torch.parallel.dryrun import dryrun_multichip
    losses = dryrun_multichip(4, "cpu")
    assert sorted(losses) == [0, 1, 2, 3]
    assert len(set(losses.values())) == 1       # every rank logs alike
    assert all(np.isfinite(x) for x in losses[0])
    out = capfd.readouterr().out
    assert "dryrun_multichip(4): mesh=(data=2, model=2)" in out
    assert "dryrun_multichip(4): AR transformer DP step" in out


def test_flash_ab_runs_each_mode_on_the_plain_versions(capsys):
    from transformer_tts_tpu_torch.cli import flash_ab
    results = flash_ab.main(["fwd", "bwd", "drop", "relpos", "64",
                             "--batch", "2", "--reps", "1", "--device",
                             "cpu"])
    assert [(r["mode"], r["path"]) for r in results] == [
        (m, p) for m in ("fwd", "bwd", "drop", "relpos")
        for p in ("kernel", "plain", "sdpa")]
    for r in results:
        assert r["T"] == 64 and r["ms"] > 0
        if r["path"] == "kernel":       # the CPU's kernel is the plain one
            assert r["max_abs_err"] == 0.0
    assert "T=64 relpos kernel" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        flash_ab.main(["blocks", "64", "--device", "cpu"])
