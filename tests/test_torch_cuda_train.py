"""LM training on the card against the CPU.

Every test here needs an NVIDIA card; on a host without CUDA the
``cuda_device`` fixture skips them.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Imports torch and the port only (no JAX), so it runs where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.tokens import DataConfig, TokenSource
from repro_torch.distributed import elastic
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed.train_loop import TrainConfig, Trainer
from repro_torch.kernels import build
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (sm_90); see module docstring")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, dev, seed=0) -> dict:
    """A seeded batch of the port's stream (B 2, S 16), on ``dev``."""
    batch = TokenSource(DataConfig(cfg.vocab_size, 2, 16, seed=seed)).global_batch_at(0)
    if cfg.family == "audio":
        g = torch.Generator().manual_seed(seed)
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
    return {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_train_step_on_card_matches_cpu(cuda_device, arch_id):
    """One f32 train step (the optimizer of the full config: kimi's
    Adafactor, AdamW elsewhere) from the same weights and batch: loss
    within 1e-5, every updated leaf within 1e-5 of its largest entry, the
    MoE router's ids equal, no flash launch."""
    cfg = dataclasses.replace(configs.get_arch(arch_id, smoke=True),
                              optimizer=configs.get_arch(arch_id).optimizer)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    if cfg.family == "hybrid":  # b_q is zeros at init: give the LoRA product a gradient
        with torch.no_grad():
            b_q = cpu.shared_attn.lora.b_q
            b_q.copy_(torch.randn(b_q.shape, generator=torch.Generator().manual_seed(1)) * 0.5)
    card = T.params_from_jax(T.params_to_numpy(cpu), cfg, cuda_device)
    ids = {"cpu": [], "cuda": []}
    route = moe_lib.router_topk

    def recording(x, router, top_k):
        probs, i, aux = route(x, router, top_k)
        ids[x.device.type].append(i.cpu())
        return probs, i, aux

    moe_lib.router_topk = recording
    try:
        out = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            # the Trainer's default schedule: lr 3e-5 at step 1 (AdamW turns an
            # f32 difference of a near-zero gradient into up to 2 lr of step)
            opt = Trainer(cfg, DataConfig(cfg.vocab_size, 2, 16), TrainConfig(),
                          device=name).optimizer
            step = T.train_step_fn(cfg, opt)
            before = build.FLASH_ATTENTION.launches
            model, state, metrics = step(model, opt.init(T.param_tree(model)),
                                         _batch(cfg, model.embed.device))
            assert build.FLASH_ATTENTION.launches == before
            out[name] = (float(metrics["loss"]), T.params_to_numpy(model))
    finally:
        moe_lib.router_topk = route
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for a, b in zip(topt.tree_leaves(out["cuda"][1]), topt.tree_leaves(out["cpu"][1])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    n_calls = cfg.n_layers * (2 if cfg.remat == "full" else 1) if cfg.family == "moe" else 0
    assert len(ids["cuda"]) == len(ids["cpu"]) == n_calls
    for a, b in zip(ids["cuda"], ids["cpu"]):
        assert torch.equal(a, b)


def test_cpu_checkpoint_resumes_on_card(cuda_device, tmp_path):
    """Two steps on the CPU, checkpointed; the card resumes through
    ``resume_elastic`` and continues the CPU's straight run."""
    arch = configs.get_arch("granite-3-8b", smoke=True)
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=16)
    straight = Trainer(arch, dc, TrainConfig(steps=4, warmup_steps=1), device="cpu").run()
    tc = TrainConfig(steps=4, warmup_steps=1, checkpoint_dir=str(tmp_path))
    Trainer(arch, dc, tc, device="cpu").run(stop_after=2)
    tr = elastic.resume_elastic(arch, dc, tc, device=cuda_device)
    out = tr.run()
    assert out["params"].embed.device.type == "cuda"
    np.testing.assert_allclose(out["losses"], straight["losses"][2:], rtol=1e-5)
    for a, b in zip(topt.tree_leaves(T.params_to_numpy(out["params"])),
                    topt.tree_leaves(T.params_to_numpy(straight["params"]))):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_bf16_checkpoint_round_trips_on_card(cuda_device, tmp_path):
    """bf16 weights and Adafactor's bf16 moment survive a checkpoint bit
    for bit (numpy has no bf16: the bit patterns are stored)."""
    arch = dataclasses.replace(configs.get_arch("olmoe-1b-7b", smoke=True),
                               dtype="bfloat16", optimizer="adafactor")
    dc = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=16)
    tc = TrainConfig(steps=2, warmup_steps=1, checkpoint_dir=str(tmp_path))
    first = Trainer(arch, dc, tc, device=cuda_device).run()
    model, opt, step = Trainer(arch, dc, tc, device=cuda_device).restore()
    assert step == 2
    for a, b in zip(topt.tree_leaves(T.param_tree(model)),
                    topt.tree_leaves(T.param_tree(first["params"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(topt.tree_leaves(opt), topt.tree_leaves(first["opt"])):
        assert a.dtype == b.dtype and torch.equal(a.to(cuda_device), b)
