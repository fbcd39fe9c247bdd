"""Port parity, part 16: LM training (``loss_fn``, autograd, ``Trainer``,
checkpoint restart, elastic resume, ``launch.train``).

The JAX package and the port take the same weights (the JAX package's,
carried across by ``transformer.params_from_jax``) and the same batches
(the JAX package's token stream, injected into the port's trainer; the
two packages' streams are their own), on the CPU.  Tolerances: the loss
within 1e-5 relative, each gradient leaf within 1e-4 of its largest entry,
trainer losses within 1e-5 relative.  Trained parameters are held to the
optimizer's bound: within 1e-6 everywhere but at most 1e-3 of the entries
(where f32 noise flips the sign of a near-zero AdamW step, or a bf16
rounding of Adafactor's moment), and none further than the summed
learning rate of the run, the most that run's steps could move it apart.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data.tokens import DataConfig as JDataConfig
from repro.distributed.train_loop import TrainConfig as JTrainConfig
from repro.distributed.train_loop import Trainer as JTrainer
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.data.tokens import DataConfig, TokenSource
from repro_torch.distributed import elastic, optimizer as topt
from repro_torch.distributed.train_loop import TrainConfig, Trainer
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(cfg, seed=0):
    """JAX smoke params as numpy; zamba2's LoRA b_q (zeros at init)
    filled with random values so its gradient path is exercised."""
    params = jT.init_params(jax.random.key(seed), cfg)
    if cfg.family == "hybrid":
        b_q = params["shared_attn"]["lora"]["b_q"]
        rnd = np.random.default_rng(seed + 50).normal(size=b_q.shape) * 0.5
        params["shared_attn"]["lora"]["b_q"] = jnp.asarray(rnd, b_q.dtype)
    return jax.tree.map(np.asarray, params)


def _batch(cfg, B=2, S=16, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _jax_loss_and_grads(params, batch, cfg):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jT.loss_fn(p, b, cfg), has_aux=True))
    (loss, metrics), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _check_loss_and_grads(cfg, jcfg, params, batch):
    jl, jm, jg = _jax_loss_and_grads(params, batch, jcfg)
    model = T.params_from_jax(params, cfg, "cpu")
    (loss, metrics), grads = T.loss_and_grads(model, _torch_batch(batch))
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl)
    for k in ("nll", "zloss"):
        assert abs(float(metrics[k]) - jm[k]) <= 1e-5 * abs(jm[k]), k
    flat = jax.tree_util.tree_leaves_with_path(jg)
    got = topt.tree_leaves(grads)
    assert len(flat) == len(got)
    for (path, want), g in zip(flat, got):
        assert g.shape == want.shape, jax.tree_util.keystr(path)
        assert _rel_err(g.numpy(), want) < 1e-4, jax.tree_util.keystr(path)
    return model, grads


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("arch_id", jconfigs.ARCH_IDS)
def test_loss_and_grads_equal_jax(arch_id):
    """Every smoke config: loss, its parts and every gradient leaf (in the
    JAX package's stacked layout) against ``jax.value_and_grad``."""
    jcfg = jconfigs.get_arch(arch_id, smoke=True)
    _check_loss_and_grads(configs.get_arch(arch_id, smoke=True), jcfg,
                          _jax_params(jcfg), _batch(jcfg))


def test_vocab_padding_masked_in_loss():
    """The JAX package's test, and the loss against JAX: the padded vocab
    columns are out of the softmax (their logits' gradient is zero)."""
    kw = dict(vocab_size=250, vocab_pad_to=256)
    jcfg = dataclasses.replace(jconfigs.get_arch("granite-3-8b", smoke=True), **kw)
    cfg = dataclasses.replace(configs.get_arch("granite-3-8b", smoke=True), **kw)
    assert cfg.vocab_padded == 256
    batch = _batch(jcfg)
    model, grads = _check_loss_and_grads(cfg, jcfg, _jax_params(jcfg), batch)
    with torch.no_grad():
        loss, _ = T.loss_fn(model, _torch_batch(batch))
    assert np.isfinite(float(loss))
    assert float(grads["lm_head"][:, 250:].abs().max()) < 1e-12


def test_positions_pass_through_for_mrope():
    """qwen2-vl's loss with three distinct position streams in the batch."""
    jcfg = jconfigs.get_arch("qwen2-vl-7b", smoke=True)
    batch = _batch(jcfg)
    rng = np.random.default_rng(6)
    batch["positions"] = np.stack([rng.integers(0, 64, (2, 16)) for _ in range(3)]).astype(np.int32)
    _check_loss_and_grads(configs.get_arch("qwen2-vl-7b", smoke=True), jcfg,
                          _jax_params(jcfg), batch)


@pytest.mark.parametrize("arch_id", ["granite-3-8b", "olmoe-1b-7b", "mamba2-370m",
                                     "zamba2-7b", "whisper-medium"])
def test_remat_gives_the_same_gradients(arch_id):
    """``remat='full'`` recomputes each block in the backward pass: the
    same loss and gradients, bit for bit, on the CPU."""
    base = configs.get_arch(arch_id, smoke=True)
    params = _jax_params(jconfigs.get_arch(arch_id, smoke=True))
    batch = _torch_batch(_batch(base))
    out = []
    for remat in ("none", "full"):
        model = T.params_from_jax(params, dataclasses.replace(base, remat=remat), "cpu")
        (loss, _), grads = T.loss_and_grads(model, batch)
        out.append((loss, topt.tree_leaves(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# --------------------------------------------------------- attention
def test_flash_attention_refuses_inputs_that_require_grad():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_lib.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_lib.flash_attention(q.detach(), k, v.requires_grad_(True))
    with torch.no_grad():  # grad mode off: the plain version, as before
        out = flash_lib.flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_lib.flash_attention_plain(q.detach(), k, v.detach()))


def test_attend_takes_chunked_attention_under_autograd(monkeypatch):
    """On a non-CPU device (meta tensors stand for the card's here) the
    training forward never reaches the kernel; outside autograd it does."""
    calls = []
    monkeypatch.setattr(flash_lib, "flash_attention",
                        lambda q, k, v, causal=True: calls.append(1) or torch.empty_like(q))
    cfg = configs.get_arch("granite-3-8b", smoke=True)
    q = torch.empty((2, 32, 4, 16), device="meta", requires_grad=True)
    k = torch.empty((2, 32, 2, 16), device="meta")
    out = L._attend(q, k, k, True, cfg)
    assert calls == [] and out.requires_grad and out.shape == q.shape
    with torch.no_grad():
        L._attend(q, k, k, True, cfg)
    with torch.inference_mode():
        L._attend(q.detach(), k, k, True, cfg)
    assert calls == [1, 1]


# ------------------------------------------------------------ the trainer
class _Batches:
    """The JAX package's token stream as the port's trainer reads it."""

    def __init__(self, source):
        self.source = source

    def global_batch_at(self, step):
        return _torch_batch({k: np.asarray(v) for k, v in
                             self.source.global_batch_at(step).items()})


def _held_to_the_optimizer_bound(got: dict, want: dict, lr_sum: float):
    flat = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(flat, jax.tree.leaves(got)):
        d = np.abs(g - np.asarray(w))
        name = jax.tree_util.keystr(path)
        assert (d > 1e-6 + 1e-6 * np.abs(w)).mean() <= 1e-3, name
        assert d.max() <= lr_sum, name


@pytest.mark.parametrize("arch_id", ["granite-3-8b", "kimi-k2-1t-a32b"])
def test_trainer_steps_equal_jax(arch_id):
    """Three Trainer steps (granite: AdamW; kimi: Adafactor, the optimizer
    of its full config) from JAX's initial parameters on JAX's batches."""
    opt = configs.get_arch(arch_id).optimizer
    assert opt == ("adamw" if arch_id.startswith("granite") else "adafactor")
    jcfg = dataclasses.replace(jconfigs.get_arch(arch_id, smoke=True), optimizer=opt)
    cfg = dataclasses.replace(configs.get_arch(arch_id, smoke=True), optimizer=opt)
    tc = dict(steps=3, warmup_steps=1, peak_lr=2e-3)
    jt = JTrainer(jcfg, JDataConfig(jcfg.vocab_size, 4, 16), JTrainConfig(**tc))
    jout = jt.run()
    tr = Trainer(cfg, DataConfig(cfg.vocab_size, 4, 16), TrainConfig(**tc), device="cpu")
    tr.data = _Batches(jt.data)
    model = T.params_from_jax(_jax_params(jcfg), cfg, "cpu")
    out = tr.run(params=model, opt=tr.optimizer.init(T.param_tree(model)))
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-5)
    lr_sum = sum(float(tr.optimizer.schedule(torch.tensor(s))) for s in (1, 2, 3))
    _held_to_the_optimizer_bound(T.params_to_numpy(out["params"]),
                                 jax.tree.map(np.asarray, jout["params"]), lr_sum)
    assert int(out["opt"]["step"]) == int(jout["opt"]["step"]) == 3


def test_param_tree_is_the_stacked_jax_layout():
    """The model's view for the optimizer: one [L, ...] tensor per stacked
    leaf, the layers' parameters its slices (an in-place write of the
    view writes the model); moved models are bound anew."""
    jcfg = jconfigs.get_arch("whisper-medium", smoke=True)
    params = _jax_params(jcfg)
    model = T.params_from_jax(params, configs.get_arch("whisper-medium", smoke=True), "cpu")
    tree = T.param_tree(model)
    assert T.param_tree(model) is tree
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert [x.shape for _, x in flat] == [tuple(t.shape) for t in topt.tree_leaves(tree)]
    for (_, want), got in zip(flat, topt.tree_leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want)
    wq = tree["blocks"]["attn"]["wq"]
    assert model.blocks[1].attn.wq.data_ptr() == wq[1].data_ptr()
    with torch.no_grad():
        wq[1].mul_(2.0)
    np.testing.assert_array_equal(model.blocks[1].attn.wq.detach().numpy(),
                                  2 * params["blocks"]["attn"]["wq"][1])
    m64 = model.double()
    assert T.param_tree(m64)["blocks"]["attn"]["wq"].dtype == torch.float64


def test_trainer_checkpoint_restart_bitexact(tmp_path):
    """Run 6 steps straight vs preempt-after-3 + resume (same config, so
    the LR schedule horizon is identical): losses must match."""
    arch = configs.get_arch("mamba2-370m", smoke=True)
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=16)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tc_a = TrainConfig(steps=6, checkpoint_every=100, checkpoint_dir=d1, warmup_steps=2)
    straight = Trainer(arch, dc, tc_a, device="cpu").run()["losses"]
    tc_b = TrainConfig(steps=6, checkpoint_every=3, checkpoint_dir=d2, warmup_steps=2)
    Trainer(arch, dc, tc_b, device="cpu").run(stop_after=3)  # preempted
    resumed = Trainer(arch, dc, tc_b, device="cpu").run()["losses"]  # restores step 3
    np.testing.assert_allclose(straight[3:], resumed, rtol=1e-5, atol=1e-6)
    assert straight[3:] == resumed  # and, on the CPU, bit for bit


def test_trainer_microbatch_equivalence():
    """Gradient accumulation over microbatches ~= single large batch."""
    arch = configs.get_arch("granite-3-8b", smoke=True)
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=8, seq_len=8)
    l1 = Trainer(arch, dc, TrainConfig(steps=2, microbatches=1, warmup_steps=1),
                 device="cpu").run()["losses"]
    l2 = Trainer(arch, dc, TrainConfig(steps=2, microbatches=4, warmup_steps=1),
                 device="cpu").run()["losses"]
    np.testing.assert_allclose(l1, l2, rtol=2e-3, atol=2e-3)


def test_microbatch_gradients_are_the_f32_mean():
    """``_accumulate_microbatches``: the f32 mean of the microbatches'
    gradients and losses, against the JAX package's scan on the same
    weights and batch."""
    from repro.distributed.train_loop import _accumulate_microbatches as j_acc
    from repro_torch.distributed.train_loop import _accumulate_microbatches as t_acc

    jcfg = jconfigs.get_arch("olmoe-1b-7b", smoke=True)
    params, batch = _jax_params(jcfg), _batch(jcfg, B=4)
    lg = jax.value_and_grad(lambda p, b: jT.loss_fn(p, b, jcfg), has_aux=True)
    jl, jm, jg = jax.jit(lambda p, b: j_acc(lg, p, b, 2))(params, jax.tree.map(jnp.asarray, batch))
    model = T.params_from_jax(params, configs.get_arch("olmoe-1b-7b", smoke=True), "cpu")
    tl, tm, tg = t_acc(T.loss_and_grads, model, _torch_batch(batch), 2)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(tm) == {"nll"} and float(tm["nll"]) == float(tl)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg), topt.tree_leaves(tg)):
        assert got.dtype == torch.float32
        assert _rel_err(got.numpy(), want) < 1e-4, jax.tree_util.keystr(path)


def test_data_restart_determinism_and_elastic_resharding():
    cfg = DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=1)
    src = TokenSource(cfg)
    a = src.global_batch_at(5)
    b = src.global_batch_at(5)
    torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
    # re-sharding is a pure re-slice of the same global batch
    s0 = src.shard_at(5, 0, 4)
    s1 = src.shard_at(5, 1, 4)
    full = a["tokens"].numpy()
    np.testing.assert_array_equal(s0["tokens"].numpy(), full[:2])
    np.testing.assert_array_equal(s1["tokens"].numpy(), full[2:4])
    wide = src.shard_at(5, 0, 2)
    np.testing.assert_array_equal(wide["tokens"].numpy(), full[:4])
    with pytest.raises(ValueError):
        src.shard_at(5, 0, 3)


def test_token_stream_has_the_jax_structure():
    """int32 [B, S] tokens and labels, labels the next token, every
    position p % 4 == 3 of the [S + 1] stream repeating p - 1; steps and
    seeds differ."""
    cfg = DataConfig(vocab_size=1000, global_batch=4, seq_len=31, seed=2)
    src = TokenSource(cfg)
    b = src.global_batch_at(0)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["tokens"].shape == b["labels"].shape == (4, 31)
    full = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    assert torch.equal(full[:, 1:], b["labels"])
    pos = torch.arange(32)
    assert torch.equal(full[:, pos % 4 == 3], full[:, (pos % 4 == 3).nonzero()[:, 0] - 1])
    assert int(full.min()) >= 0 and int(full.max()) < 1000
    assert not torch.equal(src.global_batch_at(1)["tokens"], b["tokens"])
    other = TokenSource(dataclasses.replace(cfg, seed=3)).global_batch_at(0)
    assert not torch.equal(other["tokens"], b["tokens"])


def test_lm_pillar_train_and_serve_end_to_end():
    arch = configs.get_arch("granite-3-8b", smoke=True)
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=8, seq_len=32)
    out = Trainer(arch, dc, TrainConfig(steps=30, warmup_steps=3, peak_lr=2e-3),
                  device="cpu").run()
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])  # learning happens
    with torch.inference_mode():
        cache, lg = T.prefill(out["params"], torch.ones((2, 8), dtype=torch.int32), max_len=16)
        cache, lg = T.decode_step(out["params"], cache, torch.ones((2, 1), dtype=torch.int32))
    assert torch.isfinite(lg).all()


def test_checkpoint_keeps_bf16_leaves_bit_for_bit(tmp_path):
    """numpy has no bf16: the checkpointer stores the bit patterns and
    restores bf16 tensors, on the CPU or on the device named."""
    from repro_torch.distributed.checkpoint import Checkpointer

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "m": {"a": torch.randn((4,), generator=g).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "v": torch.randn((2, 2), generator=g)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    for device in (None, "cpu"):
        out, step = ck.restore(tree, device=device)
        assert step == 1
        for a, b in zip(topt.tree_leaves(out), topt.tree_leaves(tree)):
            a = torch.as_tensor(a)
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_adafactor_bf16_run_resumes_bit_for_bit(tmp_path):
    """A bf16 model trained with Adafactor (bf16 weights and first moment
    in the checkpoint), preempted and resumed: the straight run's losses."""
    arch = dataclasses.replace(configs.get_arch("kimi-k2-1t-a32b", smoke=True),
                               dtype="bfloat16", optimizer="adafactor")
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=16)
    straight = Trainer(arch, dc, TrainConfig(steps=4, warmup_steps=1), device="cpu").run()
    tc = TrainConfig(steps=4, warmup_steps=1, checkpoint_dir=str(tmp_path))
    Trainer(arch, dc, tc, device="cpu").run(stop_after=2)
    resumed = Trainer(arch, dc, tc, device="cpu").run()
    assert resumed["losses"] == straight["losses"][2:]
    for a, b in zip(topt.tree_leaves(T.param_tree(resumed["params"])),
                    topt.tree_leaves(T.param_tree(straight["params"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.bfloat16 in {a.dtype for a in topt.tree_leaves(resumed["opt"])}


# ------------------------------------------------------------- elastic
def test_elastic_resume_from_a_jax_checkpoint(tmp_path):
    """A run checkpointed by the JAX package's trainer (the same stacked
    tree) resumes in the port through ``resume_elastic`` and continues
    JAX's straight run, loss for loss."""
    jcfg = jconfigs.get_arch("granite-3-8b", smoke=True)
    cfg = configs.get_arch("granite-3-8b", smoke=True)
    jdc = JDataConfig(jcfg.vocab_size, 4, 16)
    straight = JTrainer(jcfg, jdc, JTrainConfig(steps=4, warmup_steps=1)).run()["losses"]
    d = str(tmp_path / "ck")
    jt = JTrainer(jcfg, jdc, JTrainConfig(steps=4, warmup_steps=1, checkpoint_dir=d))
    jt.run(stop_after=2)
    tr = elastic.resume_elastic(cfg, DataConfig(cfg.vocab_size, 4, 16),
                                TrainConfig(steps=4, warmup_steps=1, checkpoint_dir=d),
                                data_shards=2, device="cpu")
    tr.data = _Batches(jt.data)
    out = tr.run()
    assert len(out["losses"]) == 2  # steps 2..3
    np.testing.assert_allclose(out["losses"], straight[2:], rtol=1e-5)


def test_elastic_resume_checks_the_shard_counts(tmp_path):
    dense = configs.get_arch("granite-3-8b", smoke=True)
    moe = configs.get_arch("olmoe-1b-7b", smoke=True)
    dc = DataConfig(vocab_size=dense.vocab_size, global_batch=4, seq_len=8)
    tc = TrainConfig(steps=2, checkpoint_dir=str(tmp_path), warmup_steps=1)
    with pytest.raises(ValueError, match="data shards"):
        elastic.resume_elastic(dense, dc, tc, data_shards=3, device="cpu")
    with pytest.raises(ValueError, match="experts"):
        elastic.resume_elastic(moe, dc, tc, model_shards=3, device="cpu")
    assert moe.n_experts % 4 == 0
    elastic.resume_elastic(moe, dc, tc, data_shards=4, model_shards=4, device="cpu")
    Trainer(dense, dc, dataclasses.replace(tc, steps=1), device="cpu").run()
    out = elastic.resume_elastic(dense, dc, tc, data_shards=2, device="cpu").run()
    assert len(out["losses"]) == 1  # resumed at step 1 of 2


def test_trainer_needs_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    arch = configs.get_arch("granite-3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(arch, DataConfig(arch.vocab_size, 2, 8), TrainConfig())


# ------------------------------------------------------------ launcher
def test_launch_train_smoke_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
           "--smoke", "--steps", "3", "--device", "cpu",
           "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[train] granite-3-8b: 3 steps, loss " in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2", "step_3"]
