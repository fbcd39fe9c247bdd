"""The Granite 4.0-H cell's harness on the CPU: the ``lm_granite``
generator end to end at a tiny size of the published layout, planted
faults, the control, the reference's init, and the SSD scan's and the
model-FLOP counts against hand counts.  The tiny manifest is this file's
own fixture."""
from __future__ import annotations

import io
import json
import math

import pytest
import torch

from nspubench import granite_faults, guard, run
from nspubench.generators import lm_granite
from nspubench.reference import granite4h as ref
from nspubench.roofline import ssd_scan as ssd_roof

CELL = "tiny-granite.rag"
# the published keys at a small shape: 4 layers with attention at id 2
# (GQA 4:2, head dim 16), 8 experts top 2 of width 24 (a decode step of 2
# tokens has a capacity of 1 an expert at cf 2.0), a shared expert of width
# 40, 8 SSM heads of 16 with d_state 16, chunk 16
TINY = {
    "name": "tiny-granite", "model_type": "granitemoehybrid", "hidden_size": 64,
    "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 24, "shared_intermediate_size": 40, "vocab_size": 128,
    "vocab_pad_to": 64, "num_local_experts": 8, "num_experts_per_tok": 2,
    "mamba_d_state": 16, "mamba_expand": 2, "mamba_d_head": 16, "mamba_n_heads": 8,
    "mamba_n_groups": 1, "mamba_chunk_size": 16, "mamba_d_conv": 4, "mamba_conv_bias": True,
    "mamba_proj_bias": False, "attention_bias": False,
    "layer_types": ["mamba", "mamba", "attention", "mamba"],
    "embedding_multiplier": 12, "residual_multiplier": 0.22,
    "attention_multiplier": 0.0625, "logits_scaling": 16, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 256, "rope_theta": 10000, "position_embedding_type": "nope",
    "hidden_act": "silu", "tie_word_embeddings": True, "initializer_range": 0.02,
}
TRAFFIC = {"generator": "lm_granite", "batch": 2, "prompt_tokens": 40, "new_tokens": 5,
           "check_requests": 2}


@pytest.fixture
def granite_root(tmp_path):
    real = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "nspubench" / "configs").mkdir(parents=True)
    (tmp_path / "nspubench" / "traffic").mkdir()
    (tmp_path / "nspubench" / "configs" / "tiny-granite.json").write_text(json.dumps(TINY))
    (tmp_path / "nspubench" / "traffic" / "tiny-rag.json").write_text(json.dumps(TRAFFIC))
    mine = "granite-4.0-h-small.rag2k"
    manifest = {
        "configs": [{"name": "tiny-granite", "file": "nspubench/configs/tiny-granite.json"}],
        "workloads": [{"name": CELL, "config": "tiny-granite", "traffic": "tiny-rag",
                       "chips": 1}],
        "end_to_end": [dict(m, workloads=[CELL]) for m in real["end_to_end"]
                       if m["name"] == "setup_s" or mine in m.get("workloads", [])],
        "per_layer": [dict(m, workloads=[CELL]) for m in real["per_layer"]
                      if mine in m["workloads"]],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _run(root, trace=False, seed=2**33 + 31, seconds=0.5):
    buf = io.StringIO()
    run.run(CELL, seed, seconds, trace, root=root, device="cpu", t_start=0.0, out=buf,
            loaded_before=guard.forbidden_modules())
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_granite_cell_end_to_end_on_the_cpu(granite_root, trace):
    line = _run(granite_root, trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0 and line["failed"] == 0
    checks = line["checks"]
    assert set(checks) == set(lm_granite.READINGS) | {"failed"}
    # float32 program against the float64 reference
    assert all(c["value"] < 1e-5 for k, c in checks.items() if k != "failed"), checks
    if not trace:
        assert set(line["metrics"]) == {"serve_p50_ms", "serve_p95_ms", "served_per_s",
                                        "setup_s"}
    else:
        # no device trace and no CUDA events on the CPU: the program's spans
        # and counters are read, nothing else
        assert set(line["metrics"]) == {"lm.prefill_ms_per_batch.rag2k",
                                        "lm.decode_ms_per_token.rag2k",
                                        "moe.experts_hit_pct.rag2k"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
        assert line["metrics"]["moe.experts_hit_pct.rag2k"]["value"] <= 100


def test_the_window_keeps_the_drawn_requests_and_their_moe_outputs():
    """Reservoir sampling keeps ``check_requests`` requests, each with its
    prompt, tokens, logits, cache rows and each MoE block's output on the
    prompt; the tracer's snapshot holds a prefill span a batch, an
    ``lm.moe`` span a layer and batch outside the decode graph and the
    MoE counters of every block."""
    gen = lm_granite.Generator(TINY, TRAFFIC, 5, torch.device("cpu"), 0.3)
    gen.setup()
    gen.window(0.3)
    s = gen.summary()
    kept = [x for x in gen.slots if x is not None]
    assert len(kept) == 2 and len({i for i, _ in kept}) == 2
    for _, out in kept:
        assert out["prefill"].shape == (40, 128) and out["steps"].shape == (4, 128)
        assert out["moe"].shape == (4, 40, 64) and out["moe_decode"].shape == (4, 4, 64)
        assert out["cache"]["S"].shape == (3, 8, 16, 16)
        assert out["cache"]["k"].shape == (1, 46, 2, 16)
        assert out["cache"]["route"].shape == (4, 2)
    snap = s["work"]["obs"]
    names = [x[0] for x in snap["spans"]]
    batches = s["work"]["batches"]
    assert names.count("lm.prefill") == batches == gen.requests // 2
    # eager decode on the CPU: a span a block in both phases
    assert names.count("lm.moe") == 4 * batches * 5
    c = snap["counters"]
    assert c["lm.moe_blocks"] == 4 * batches * 5
    assert c["lm.moe_assignments"] == 4 * batches * (2 * 40 + 4 * 2) * 2
    assert c["lm.moe_experts_hit"] <= 8 * c["lm.moe_blocks"]
    assert c["lm.moe_max_load"] >= c["lm.moe_assignments"] / 8
    assert c["lm.tokens_decoded"] == s["work"]["tokens_decoded"]


@pytest.mark.parametrize("fault", [f for f in granite_faults.FAULTS
                                   if f != granite_faults.NOT_CARRIED])
def test_planted_fault_is_not_correct(granite_root, monkeypatch, fault):
    """Each planted fault comes out not correct at the smoke size.  The
    capacity path drops only where more than cap_e tokens of a step pick an
    expert: at the cell's size (8 tokens, top 10 of 72, cap_e 2) ~6 experts
    a block do; here each batch holds one prompt twice, so the two rows of
    every decode step pick the same experts and each expert's second
    assignment (the second row's) is dropped (cap_e 1), and every request
    of the window is checked."""
    granite_faults.plant(fault, monkeypatch.setattr)
    if fault == granite_faults.FAULTS[0]:
        real = lm_granite.Generator._prompts
        monkeypatch.setattr(lm_granite.Generator, "_prompts",
                            lambda self, i: real(self, i)[:1].expand(self.B, -1))
        (granite_root / "nspubench" / "traffic" / "tiny-rag.json").write_text(
            json.dumps(dict(TRAFFIC, check_requests=1000)))
    line = _run(granite_root)
    assert line["correct"] is False, (fault, line["checks"])


def _slow_decays(monkeypatch):
    """Weights whose SSM carries its state across chunks: A = -1e-3 a head
    and dt_bias -4 (softplus ~0.018), where the published init's A = -1..-H
    and dt_bias 1 decay a state by e^-20 within a chunk of 16."""
    real = ref.draw

    def draw(conf, name, shape, rule, seed, device, dtype=torch.bfloat16):
        if rule == "A_log":
            return torch.full(shape, math.log(1e-3), dtype=torch.float32, device=device)
        if rule == "dt_bias":
            return torch.full(shape, -4.0, dtype=torch.float32, device=device)
        return real(conf, name, shape, rule, seed, device, dtype)

    monkeypatch.setattr(ref, "draw", draw)


def test_state_not_carried_is_hidden_by_the_init_and_seen_where_the_state_lives(
        granite_root, monkeypatch):
    """Under the published init a state does not outlive a chunk (its
    carry is below f32's range), so the fault changes nothing the check
    can read; with decays that carry the state it fails the check."""
    granite_faults.plant(granite_faults.NOT_CARRIED, monkeypatch.setattr)
    assert _run(granite_root)["correct"] is True
    _slow_decays(monkeypatch)
    line = _run(granite_root)
    assert line["correct"] is False, line["checks"]


def test_fault_probe_reads_each_fault_over_a_limit(granite_root):
    """``granite_faults.probe`` (what runs on the card at full size) at
    the smoke size: the sound program under every limit, each fault the
    published init does not hide over one."""
    manifest = json.loads((granite_root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, CELL, granite_root)
    lines = granite_faults.probe(cell, [11], 0.2, torch.device("cpu"), control=False,
                                 out=io.StringIO())
    assert [x["kind"] for x in lines] == (["program", "witness"]
                                          + ["fault"] * len(granite_faults.FAULTS))
    assert not any(r["over"] for r in lines[0]["readings"].values())
    for x in lines[2:]:
        over = any(r["over"] for r in x["readings"].values())
        assert over == (x["fault"] != granite_faults.NOT_CARRIED), x


def test_control_with_its_sums_in_bfloat16_is_not_correct():
    """The reference with every sum held in bf16, in the program's place,
    fails the CPU's limits by far at the smoke size; the card's limits hold
    the bf16 program, and the control's full-size readings lie over them
    (PERF.md, section 6)."""
    traffic = dict(TRAFFIC, prompt_tokens=120, new_tokens=4)
    gen = lm_granite.Generator(TINY, traffic, 3, torch.device("cpu"), 0.0)
    gen.plan_control(0.0)
    checks = gen.check(full=False, control=True)["checks"]
    assert all(v > 10 * lim for k, (v, lim) in checks.items() if k != "failed"), checks


def test_reference_init_follows_the_published_rule():
    """Each tensor by ``_init_weights``' rule, from its own generator: the
    same values when drawn again, whatever else was drawn first."""
    lazy = ref.LazyState(TINY, 9, "cpu", torch.float32)
    assert list(lazy) == [n for n, _, _ in ref.tensor_specs(TINY)]
    m = "model.layers.0.mamba."
    assert torch.equal(lazy[m + "A_log"], torch.log(torch.arange(1.0, 9.0)))
    assert torch.equal(lazy[m + "dt_bias"], torch.ones(8))
    assert torch.equal(lazy[m + "D"], torch.ones(8)) and lazy[m + "D"].dtype == torch.float32
    assert torch.equal(lazy[m + "conv1d.bias"], torch.zeros(64 * 2 + 32))
    assert torch.equal(lazy["model.layers.2.post_attention_layernorm.weight"], torch.ones(64))
    w = lazy["model.layers.3.block_sparse_moe.input_linear.weight"]
    assert w.shape == (8, 48, 64) and abs(float(w.std()) - 0.02) < 2e-3
    assert torch.equal(w, lazy["model.layers.3.block_sparse_moe.input_linear.weight"])
    other = ref.LazyState(TINY, 9, "cpu", torch.float32)
    assert torch.equal(other["model.layers.2.self_attn.q_proj.weight"],
                       lazy["model.layers.2.self_attn.q_proj.weight"])
    assert not torch.equal(ref.LazyState(TINY, 10, "cpu", torch.float32)[
        "model.embed_tokens.weight"], lazy["model.embed_tokens.weight"])
    assert lazy["model.embed_tokens.weight"].shape == (128, 64)
    assert ref.LazyState(TINY, 9, "cpu")["model.norm.weight"].dtype == torch.bfloat16


def test_ssd_scan_launch_counted_by_hand():
    # b 1, L 5, chunk 4: pairs 4*5/2 + 1 = 11; H 2, N 8, dh 16, G 1
    it = dict(b=1, L=5, H=2, G=1, N=8, dh=16, chunk=4)
    assert ssd_roof.pairs(5, 4) == 11
    ops = 2 * (2 * (8 + 16) * 11 + 4 * 8 * 16 * 5)
    nbytes = 2 * 5 * (2 * 16 + 2 * 8) + 4 * 5 * 2 + 4 * 5 * 2 * 16 + 4 * 2 * 8 * 16
    assert ssd_roof.count(it) == (ops, nbytes)
    pk = ssd_roof.PEAKS["NVIDIA H100 80GB HBM3"]
    kernels = {"void tc::ssd_kernel<128, 64, 256>(Args)": [1e-6, 1],
               "void tc::flash_kernel<128, 128>(CUtensorMap, ...)": [5.0, 1]}
    want = 100 * max(ops / pk["bf16_ops_per_s"], nbytes / pk["hbm_bytes_per_s"]) / 1e-6
    assert ssd_roof.share_pct([it], kernels, "NVIDIA H100 80GB HBM3") == pytest.approx(want)
    assert ssd_roof.share_pct([it], kernels, "a card nobody listed") is None
    assert ssd_roof.share_pct([], kernels, "NVIDIA H100 80GB HBM3") is None


def test_the_cells_shapes_and_counts():
    """The generator's SSD items (one a mamba layer and prefill) and model
    FLOPs at the cell's configuration and traffic, against hand counts."""
    root = run.ROOT
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, "granite-4.0-h-small.rag2k", root)
    conf, tr = cell["config"], cell["traffic"]
    assert (tr["batch"], tr["prompt_tokens"], tr["new_tokens"]) == (8, 1920, 128)
    gen = lm_granite.Generator(conf, tr, 1, torch.device("cpu"), 0.0)
    gen.requests = 3 * 8
    counts = gen._counts()
    assert counts["ssd_scan"] == [dict(b=8, L=1920, H=128, G=1, N=128, dh=64, chunk=256)] * 108
    ops, nbytes = ssd_roof.count(counts["ssd_scan"][0])
    assert nbytes == 804_257_792 and ops == 158_217_535_488
    # by hand: active parameters a token, 2 a parameter (8,803,121,664 less
    # the 36 x (128 + 8) SSM gains and norms and the layers' norms)
    D, L = 4096, 40
    mamba = D * (8192 + 8448 + 128) + 8192 * D
    attn = 2 * D * 4096 + 2 * D * 1024
    ffn = D * 72 + 10 * 3 * D * 768 + 3 * D * 1536
    params = 36 * mamba + 4 * attn + L * ffn + D * 100352
    B, S, steps = 8, 1920, 127
    mat = 2 * params * B * (S + steps)
    att = 4 * 4096 * 4 * B * (S * (S + 1) // 2 + sum(S + s + 1 for s in range(steps)))
    ssd = 36 * B * S * (2 * 256 * 128 + 2 * 256 * 64 * 128 + 4 * 128 * 64 * 128) \
        + 36 * B * steps * 4 * 128 * 64 * 128
    assert lm_granite.model_flops(conf, B, S, 128) == mat + att + ssd
    assert counts["ops"] == 3 * (mat + att + ssd)
    # about 17.6 GFLOP a prompt token in the products
    assert 17.5e9 < 2 * params < 17.7e9
