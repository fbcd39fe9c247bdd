"""The LM cell's harness on the CPU: the ``lm_batch`` generator end to end
at the smoke size of Zamba2 as published, planted faults, the control,
and the flash and model-FLOP counts against hand counts.  The tiny
manifest is this file's own fixture (``conftest.py`` holds the TNN cells')."""
from __future__ import annotations

import io
import json

import pytest
import torch

from nspubench import guard, run
from nspubench.generators import lm_batch
from nspubench.lm_faults import FAULTS, plant
from nspubench.reference import zamba2 as ref
from nspubench.roofline import flash_attention as flash_roof

CELL = "tiny-zamba2.docs"
# the published keys at a small instruct shape: 7 layers with hybrid ids 2
# and 5, two mem blocks, 2 SSM groups, chunk 16, adapter rank 4, head dim
# 2 * 32 / 4 = 16
TINY = {
    "name": "tiny-zamba2", "hidden_size": 32, "num_hidden_layers": 7,
    "num_attention_heads": 4, "num_key_value_heads": 4, "intermediate_size": 48,
    "vocab_size": 64, "vocab_pad_to": 64, "mamba_d_state": 8, "mamba_expand": 2,
    "mamba_d_conv": 4, "n_mamba_heads": 4, "mamba_ngroups": 2, "chunk_size": 16,
    "rope_theta": 10000, "hybrid_layer_ids": [2, 5], "num_mem_blocks": 2,
    "adapter_rank": 4, "use_conv_bias": True, "hidden_act": "gelu", "rms_norm_eps": 1e-5,
    "time_step_min": 0.001, "time_step_max": 0.1, "time_step_floor": 1e-4,
    "max_position_embeddings": 256, "initializer_range": 0.02, "pad_token_id": 0,
}
TRAFFIC = {"generator": "lm_batch", "batch": 2, "prompt_tokens": 40, "new_tokens": 5,
           "check_requests": 2}


@pytest.fixture
def lm_root(tmp_path):
    real = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "nspubench" / "configs").mkdir(parents=True)
    (tmp_path / "nspubench" / "traffic").mkdir()
    (tmp_path / "nspubench" / "configs" / "tiny-zamba2.json").write_text(json.dumps(TINY))
    (tmp_path / "nspubench" / "traffic" / "tiny-docs.json").write_text(json.dumps(TRAFFIC))
    mine = "zamba2-7b-instruct.docs4k"
    manifest = {
        "configs": [{"name": "tiny-zamba2", "file": "nspubench/configs/tiny-zamba2.json"}],
        "workloads": [{"name": CELL, "config": "tiny-zamba2", "traffic": "tiny-docs",
                       "chips": 1}],
        "end_to_end": [dict(m, workloads=[CELL]) for m in real["end_to_end"]
                       if m["name"] == "setup_s" or mine in m.get("workloads", [])],
        "per_layer": [dict(m, workloads=[CELL]) for m in real["per_layer"]
                      if mine in m["workloads"]],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _run(root, trace=False, seed=2**33 + 27, seconds=0.5):
    buf = io.StringIO()
    run.run(CELL, seed, seconds, trace, root=root, device="cpu", t_start=0.0, out=buf,
            loaded_before=guard.forbidden_modules())
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_lm_cell_end_to_end_on_the_cpu(lm_root, trace):
    line = _run(lm_root, trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0 and line["failed"] == 0
    checks = line["checks"]
    # float32 program against the float64 reference
    assert all(c["value"] < 1e-5 for k, c in checks.items() if k != "failed"), checks
    if not trace:
        assert set(line["metrics"]) == {"serve_p50_ms", "serve_p95_ms", "served_per_s",
                                        "setup_s"}
        m = line["metrics"]
        assert m["serve_p50_ms"]["value"] <= m["serve_p95_ms"]["value"]
    else:
        # no device trace on the CPU: the program's spans are read, nothing else
        assert set(line["metrics"]) == {"lm.prefill_ms_per_batch", "lm.decode_ms_per_token"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_the_window_keeps_the_drawn_requests_only(lm_root):
    """Reservoir sampling keeps ``check_requests`` requests, each with its
    prompt, tokens, prefill logits and decode-step logits; the snapshot of
    the program's tracer holds one prefill span a batch."""
    gen = lm_batch.Generator(TINY, TRAFFIC, 5, torch.device("cpu"), 0.3)
    gen.setup()
    gen.window(0.3)
    s = gen.summary()
    kept = [x for x in gen.slots if x is not None]
    assert len(kept) == 2 and len({i for i, _ in kept}) == 2
    assert all(i < gen.requests for i, _ in kept)
    for _, out in kept:
        assert out["prefill"].shape == (40, 64) and out["steps"].shape == (4, 64)
        assert out["tokens"].shape == (5,) and out["prompt"].shape == (40,)
    spans = [x[0] for x in s["work"]["obs"]["spans"]]
    assert spans.count("lm.prefill") == s["work"]["batches"] == gen.requests // 2
    assert s["work"]["obs"]["counters"]["lm.tokens_decoded"] == s["work"]["tokens_decoded"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(lm_root, monkeypatch, fault):
    """Each planted fault comes out not correct, in the paths the logits
    barely see under the published init (the SSM's state, the decode KV,
    an adapter) as well: the K and V of every application and the final
    SSM states are compared too."""
    plant(fault, monkeypatch.setattr)
    line = _run(lm_root)
    assert line["correct"] is False, (fault, line["checks"])


def test_fault_probe_reads_every_fault_over_a_limit(lm_root):
    """``lm_faults.probe`` (what runs on the card at full size) at the
    smoke size on the CPU: the sound program under every limit, each
    planted fault over one, the program's model left as it was."""
    from nspubench import lm_faults

    manifest = json.loads((lm_root / "BENCHMARK.json").read_text())
    cell = run.find_cell(manifest, CELL, lm_root)
    lines = lm_faults.probe(cell, [11], 0.2, torch.device("cpu"), control=False,
                            out=io.StringIO())
    kinds = [x["kind"] for x in lines]
    assert kinds == ["program", "witness"] + ["fault"] * len(FAULTS)
    assert not any(r["over"] for r in lines[0]["readings"].values())
    for x in lines[2:]:
        assert any(r["over"] for r in x["readings"].values()), x["fault"]


def test_control_with_its_sums_in_bfloat16_is_not_correct():
    """The reference with every sum held in bf16 (the control), in the
    program's place, against the float64 reference fails the CPU's limits
    (the program's f32) by far, at the smoke size; the card's limits hold
    the bf16 program, which reads under half of them, and the control
    fails those at full size (PERF.md, section 6)."""
    traffic = dict(TRAFFIC, prompt_tokens=200, new_tokens=4)
    gen = lm_batch.Generator(TINY, traffic, 3, torch.device("cpu"), 0.0)
    gen.plan_control(0.0)
    checks = gen.check(full=False, control=True)["checks"]
    assert all(v > 10 * lim for k, (v, lim) in checks.items() if k != "failed"), checks
    card, cpu = lm_batch.LIMITS["bfloat16"], lm_batch.LIMITS["float32"]
    assert all(card[k] > 100 * cpu[k] for k in card if k != "failed")


def test_flash_launch_counted_by_hand():
    # causal prefill, b 2, h 3, d 224, S 5: 15 pairs a (b, h); 4 * 224 * 15 * 6
    # operations; bytes 2 * 224 * 6 * (2 * 5 + 2 * 5)
    it = dict(b=2, h=3, d=224, sq=5, skv=5, causal=True)
    assert flash_roof.count(it) == (4 * 224 * 15 * 6, 2 * 224 * 6 * 20)
    # a decode row over 7 keys: 7 pairs
    it = dict(b=1, h=1, d=224, sq=1, skv=7, causal=False)
    assert flash_roof.count(it) == (4 * 224 * 7, 2 * 224 * (2 + 14))
    assert flash_roof.pairs(dict(sq=3, skv=5, causal=True)) == 1 + 2 + 3
    pk = flash_roof.PEAKS["NVIDIA H100 80GB HBM3"]
    kernels = {"void tc::flash_kernel<256, 224>(CUtensorMap, ...)": [1e-6, 1],
               "void tc::flash_kernel<128, 112>(CUtensorMap, ...)": [5.0, 1]}
    want = 100 * max(4 * 224 * 7 / pk["bf16_ops_per_s"], 2 * 224 * 16 / pk["hbm_bytes_per_s"]) / 1e-6
    assert flash_roof.share_pct([it], kernels, "NVIDIA H100 80GB HBM3") == pytest.approx(want)
    assert flash_roof.share_pct([it], kernels, "a card nobody listed") is None
    assert flash_roof.share_pct([], kernels, "NVIDIA H100 80GB HBM3") is None


def test_launches_and_model_flops_counted_by_hand():
    gen = lm_batch.Generator(TINY, dict(TRAFFIC, prompt_tokens=6, new_tokens=3),
                             1, torch.device("cpu"), 0.0)
    launches = gen._launches()
    # 2 applications: a prefill each, then 2 decode steps each over 7 and 8 keys
    assert [(x["sq"], x["skv"], x["causal"]) for x in launches] == (
        [(6, 6, True)] * 2 + [(1, 7, False)] * 2 + [(1, 8, False)] * 2)
    d = ref.dims(TINY)
    assert (d["Di"], d["H"], d["P"], d["conv"], d["hd"]) == (64, 4, 16, 96, 16)
    # by hand: per token, mamba 32 * (64 + 96 + 4) + 64 * 32 = 7,296 a layer;
    # shared 64 * 3 * 64 + 64 * 32 + 32 * 96 + 48 * 32 + 32 * 4 + 4 * 96
    # + 32 * 32 = 20,480 an application; head 32 * 64
    params = 7 * 7296 + 2 * 20480 + 2048
    B, S, steps = 2, 6, 2
    mat = 2 * params * B * (S + steps)
    attn = 4 * 64 * 2 * B * (21 + 7 + 8)
    ssd = 7 * B * S * (2 * 16 * 8 * 2 + 2 * 16 * 16 * 4 + 4 * 8 * 16 * 4) + 7 * B * 2 * (
        4 * 8 * 16 * 4)
    assert lm_batch.model_flops(TINY, B, S, 3) == mat + attn + ssd
