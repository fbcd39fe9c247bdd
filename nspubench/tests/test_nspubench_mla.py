"""The Kanana-2 (MLA) cell's harness on the CPU: the ``lm_mla`` generator
end to end at a tiny size of the published layout, the control, planted
faults, the reference's init, and the MLA flash kernel's and the
model-FLOP counts against hand counts.  The tiny manifest is this file's
own fixture."""
from __future__ import annotations

import io
import json

import pytest
import torch

from nspubench import guard, mla_faults, run
from nspubench.generators import lm_mla
from nspubench.reference import deepseek_v3 as ref
from nspubench.roofline import flash_mla as mla_roof

CELL = "tiny-kanana.longdoc"
# the published keys at a small shape: 3 layers (one dense), 2 heads at
# the published head widths (q and k 128 + 64, v 128), a latent of 32 + 64,
# 8 experts top 3 of width 24, one shared expert
TINY = {
    "name": "tiny-kanana", "model_type": "deepseek_v3", "hidden_size": 64,
    "num_hidden_layers": 3, "num_attention_heads": 2, "num_key_value_heads": 2,
    "intermediate_size": 96, "moe_intermediate_size": 24, "n_routed_experts": 8,
    "n_shared_experts": 1, "num_experts_per_tok": 3, "first_k_dense_replace": 1,
    "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "qk_head_dim": 192, "head_dim": 64, "v_head_dim": 128, "routed_scaling_factor": 2.448,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "norm_topk_prob": True,
    "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "rope_theta": 1000000,
    "rope_scaling": None, "rope_interleave": True, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 256, "vocab_size": 128, "vocab_pad_to": 64,
    "hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False,
    "initializer_range": 0.02,
}
TRAFFIC = {"generator": "lm_mla", "batch": 2, "prompt_tokens": 40, "new_tokens": 5,
           "check_requests": 2, "compare_positions": 8}
MINE = "kanana-2-30b-a3b-instruct.longdoc32k"


@pytest.fixture
def mla_root(tmp_path):
    real = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "nspubench" / "configs").mkdir(parents=True)
    (tmp_path / "nspubench" / "traffic").mkdir()
    (tmp_path / "nspubench" / "configs" / "tiny-kanana.json").write_text(json.dumps(TINY))
    (tmp_path / "nspubench" / "traffic" / "tiny-longdoc.json").write_text(json.dumps(TRAFFIC))
    manifest = {
        "configs": [{"name": "tiny-kanana", "file": "nspubench/configs/tiny-kanana.json"}],
        "workloads": [{"name": CELL, "config": "tiny-kanana", "traffic": "tiny-longdoc",
                       "chips": 1}],
        "end_to_end": [dict(m, workloads=[CELL]) for m in real["end_to_end"]
                       if m["name"] == "setup_s" or MINE in m.get("workloads", [])],
        "per_layer": [dict(m, workloads=[CELL]) for m in real["per_layer"]
                      if MINE in m["workloads"]],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _run(root, trace=False, seed=2**33 + 37, seconds=0.5):
    buf = io.StringIO()
    run.run(CELL, seed, seconds, trace, root=root, device="cpu", t_start=0.0, out=buf,
            loaded_before=guard.forbidden_modules())
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_mla_cell_end_to_end_on_the_cpu(mla_root, trace):
    line = _run(mla_root, trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0 and line["failed"] == 0
    checks = line["checks"]
    assert set(checks) == set(lm_mla.READINGS) | {"failed"}
    # float32 program against the float64 reference
    assert all(c["value"] < 1e-5 for k, c in checks.items() if k != "failed"), checks
    if not trace:
        assert set(line["metrics"]) == {"serve_p50_ms", "serve_p95_ms", "served_per_s",
                                        "setup_s"}
    else:
        # no device trace and no CUDA events on the CPU: the program's spans
        # and counters are read, nothing else
        assert set(line["metrics"]) == {"lm.prefill_ms_per_batch.longdoc32k",
                                        "lm.decode_ms_per_token.longdoc32k",
                                        "moe.experts_hit_pct.longdoc32k"}
        assert line["metrics"]["moe.experts_hit_pct.longdoc32k"]["value"] <= 100.0
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_the_window_keeps_the_drawn_requests_at_the_compared_positions():
    """Reservoir sampling keeps ``check_requests`` requests, each with its
    prompt, tokens, the logits at the compared prompt positions and every
    step's, its latent rows and each MoE block's output there; the
    compared positions are the prompt's last half and as many drawn from
    the seed, the same for every request of a run."""
    gen = lm_mla.Generator(TINY, TRAFFIC, 5, torch.device("cpu"), 0.3)
    assert gen.at[-4:] == [36, 37, 38, 39] and len(set(gen.at)) == 8
    assert gen.at == sorted(gen.at) and all(p < 36 for p in gen.at[:4])
    assert gen.at == lm_mla.Generator(TINY, TRAFFIC, 5, torch.device("cpu"), 0.3).at
    assert gen.at != lm_mla.Generator(TINY, TRAFFIC, 6, torch.device("cpu"), 0.3).at
    gen.setup()
    gen.window(0.3)
    s = gen.summary()
    kept = [x for x in gen.slots if x is not None]
    assert len(kept) == 2 and len({i for i, _ in kept}) == 2
    for _, out in kept:
        assert out["prefill"].shape == (8, 128) and out["steps"].shape == (4, 128)
        assert out["latent"].shape == (3, 8 + 4, 32 + 64)
        assert out["moe"].shape == (2, 8, 64) and out["moe_decode"].shape == (2, 4, 64)
        assert out["gates"].shape == (8, 8) and bool(((out["gates"] > 0).sum(-1) == 3).all())
        # each MoE block's chosen experts at every position of the prompt
        # and of the decode steps, the first block's those the gates show
        assert out["route"].shape == (2, 40 + 4, 3) and out["route"].dtype == torch.int16
        first = out["route"][0, gen.at].long()
        assert bool((out["gates"].gather(1, first) > 0).all())
    snap = s["work"]["obs"]
    names = [x[0] for x in snap["spans"]]
    batches = s["work"]["batches"]
    assert names.count("lm.prefill") == batches == gen.requests // 2
    # a row at a time at prefill, then eager decode on the CPU: a span a
    # block in both phases
    assert names.count("lm.mla") == 3 * batches * (2 + 4)
    assert names.count("lm.moe") == 2 * batches * (2 + 4)
    c = snap["counters"]
    assert c["lm.mla_pairs"] == 3 * batches * 2 * 2 * 40 * 41 // 2
    assert c["lm.mla_latent_bytes"] == 3 * batches * 2 * (40 + 4) * 96 * 4


@pytest.mark.parametrize("fault", mla_faults.FAULTS)
def test_planted_fault_is_not_correct(mla_root, monkeypatch, fault):
    """Each planted fault comes out not correct at the smoke size."""
    mla_faults.plant(fault, monkeypatch.setattr)
    line = _run(mla_root)
    assert line["correct"] is False, (fault, line["checks"])


def test_fault_probe_reads_each_fault_over_a_limit(mla_root):
    """``mla_faults.probe`` (what runs on the card at full size) at the
    smoke size: the sound program under every limit, each fault over one."""
    manifest = json.loads((mla_root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, CELL, mla_root)
    lines = mla_faults.probe(cell, [11], 0.2, torch.device("cpu"), control=False,
                             out=io.StringIO())
    assert [x["kind"] for x in lines] == ["program", "witness"] + ["fault"] * len(
        mla_faults.FAULTS)
    assert not any(r["over"] for r in lines[0]["readings"].values())
    for x in lines[2:]:
        assert any(r["over"] for r in x["readings"].values()), x


def test_control_with_its_sums_in_bfloat16_is_not_correct():
    """The reference with every sum held in bf16, in the program's place,
    fails every one of the CPU's limits at the smoke size but the choice's
    (``route_differ``: none of its 126 choices here falls within a bf16
    rounding of a tie, so it reads 0), all but the gates' by far (the
    router's logits sum 64 terms here); the card's limits hold the bf16
    program, and the control's full-size readings lie over them (PERF.md,
    section 6)."""
    traffic = dict(TRAFFIC, prompt_tokens=60, new_tokens=4)
    gen = lm_mla.Generator(TINY, traffic, 3, torch.device("cpu"), 0.0)
    gen.plan_control(0.0)
    checks = gen.check(full=False, control=True)["checks"]
    assert checks["route_differ"][0] == 0.0
    assert all(v > lim for k, (v, lim) in checks.items()
               if k not in ("failed", "route_differ")), checks
    assert all(v > 10 * lim for k, (v, lim) in checks.items()
               if k not in ("failed", "gates_rel_first", "route_differ")), checks


def test_reference_init_follows_the_published_rule():
    """Each tensor by ``_init_weights``' rule, from its own generator, and
    the router's bias N(0, 0.05^2) in f32."""
    lazy = ref.LazyState(TINY, 9, "cpu", torch.float32)
    assert list(lazy) == [n for n, _, _ in ref.tensor_specs(TINY)]
    assert lazy["lm_head.weight"].shape == (128, 64)
    assert "model.layers.0.mlp.gate_proj.weight" in lazy
    assert "model.layers.0.mlp.gate.weight" not in lazy
    w = lazy["model.layers.2.mlp.experts.7.down_proj.weight"]
    assert w.shape == (64, 24)
    assert torch.equal(w, lazy["model.layers.2.mlp.experts.7.down_proj.weight"])
    b = ref.LazyState(TINY, 9, "cpu")["model.layers.1.mlp.gate.e_score_correction_bias"]
    assert b.dtype == torch.float32 and b.shape == (8,)
    assert ref.LazyState(TINY, 9, "cpu")["model.norm.weight"].dtype == torch.bfloat16


def test_flash_mla_launch_counted_by_hand():
    # b 1, 5 rows causal, 2 heads: pairs 15; ops (2 * 192 + 2 * 128) a pair a head
    it = dict(b=1, sq=5, skv=5, h=2, dqk=192, dv=128, causal=True)
    assert mla_roof.pairs(it) == 15
    ops = 640 * 15 * 2
    nbytes = 2 * 2 * (5 * 192 + 5 * 192 + 5 * 128 + 5 * 128)
    assert mla_roof.count(it) == (ops, nbytes)
    pk = mla_roof.PEAKS["NVIDIA H100 80GB HBM3"]
    kernels = {"void tc::flash_mla_kernel<192, 128>(CUtensorMap, ...)": [1e-6, 1],
               "void tc::flash_kernel<256, 224>(CUtensorMap, ...)": [5.0, 1]}
    want = 100 * max(ops / pk["bf16_ops_per_s"], nbytes / pk["hbm_bytes_per_s"]) / 1e-6
    assert mla_roof.share_pct([it], kernels, "NVIDIA H100 80GB HBM3") == pytest.approx(want)
    assert mla_roof.share_pct([it], kernels, "a card nobody listed") is None
    assert mla_roof.share_pct([], kernels, "NVIDIA H100 80GB HBM3") is None
    # the cell's launch: 32 heads over a 32,704-token row, bound by operations
    row = dict(b=1, sq=32704, skv=32704, h=32, dqk=192, dv=128, causal=True)
    ops, nbytes = mla_roof.count(row)
    assert ops == 640 * 32 * 32704 * 32705 // 2
    assert 11.0e-3 < ops / pk["bf16_ops_per_s"] < 11.2e-3 > nbytes / pk["hbm_bytes_per_s"]


def test_the_cells_shapes_and_counts():
    """The generator's flash items (one a layer and prompt row) and model
    FLOPs at the cell's configuration and traffic, against hand counts."""
    root = run.ROOT
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, MINE, root)
    conf, tr = cell["config"], cell["traffic"]
    assert (tr["batch"], tr["prompt_tokens"], tr["new_tokens"], tr["check_requests"]) == (
        4, 32704, 64, 2)
    assert tr["prompt_tokens"] + tr["new_tokens"] == conf["max_position_embeddings"]
    assert conf["reduced"] == [] and cell["cell"]["chips"] == 1
    gen = lm_mla.Generator(conf, tr, 1, torch.device("cpu"), 0.0)
    assert len(gen.at) == 128 and gen.at[-1] == 32703
    gen.requests = 3 * 4
    counts = gen._counts()
    assert counts["flash_mla"] == [dict(b=1, sq=32704, skv=32704, h=32, dqk=192, dv=128,
                                        causal=True)] * (48 * 4 * 3)
    # by hand: 2 a matmul parameter a token, the head at 129 positions a
    # prompt and every step, 640 a causal pair a head at prefill, 2 x 576
    # + 2 x 512 a cached row a head at decode
    D, H = 2048, 32
    mla = D * H * 192 + D * 576 + 512 * H * 256 + H * 128 * D
    moe = D * 128 + 6 * 3 * D * 768 + 3 * D * 1536
    params = 48 * mla + 3 * D * 6144 + 47 * moe
    B, S, steps = 4, 32704, 63
    mat = 2 * params * B * (S + steps) + 2 * D * 128256 * B * (129 + steps)
    att = 640 * H * 48 * B * S * (S + 1) // 2
    dec = (2 * 576 + 2 * 512) * H * 48 * B * sum(S + s + 1 for s in range(steps))
    assert lm_mla.model_flops(conf, B, S, 64, 129) == mat + att + dec
    assert counts["ops"] == 3 * (mat + att + dec)
    assert 2.93e15 < mat + att + dec < 2.95e15  # 2.94e15 FLOP a batch
