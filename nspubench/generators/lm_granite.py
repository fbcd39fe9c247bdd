"""Closed loop of batched LM requests to Granite 4.0-H as published
through the port's serving path (``repro_torch.launch.serve.serve``:
``transformer.prefill``, then greedy decode steps as one CUDA graph on
the card), one client, batches back to back until the window has passed.

Each batch is ``batch`` prompts of ``prompt_tokens`` token ids drawn
uniformly over the vocabulary from the seed (batch i from its own derived
seed), and ``new_tokens`` greedily decoded tokens a prompt.  A request is
timed from the submission of its batch to the return of the call that
produced its last token.  The weights are drawn by the configuration's
published init rule, each tensor from its own generator
(``reference.granite4h.LazyState``), and loaded tensor by tensor by the
program's loader of the published parameter names
(``transformer.params_from_hf``), so the weights never exist twice.  The
program's tracer (``repro_torch.obs``) is on over the window; its snapshot
reaches the per-layer readers through ``summary()['work']['obs']``.

``correct``: ``check_requests`` requests are drawn from the seed among the
window's, as ``lm_batch`` draws them (only theirs are kept on the device:
their logits, their rows of the final cache and of each MoE block's output
on the prompt).  For each, the reference's full forward over the prompt
plus the program's own greedy tokens (teacher forcing), its weights drawn
again one layer at a time, gives logits at every position, each attention
layer's K and V, each mamba layer's final SSM state and each MoE block's
output.  Compared with the program's (``READINGS``, each a largest
relative error ||got - want|| / ||want||):

* the prefill logits at every prompt position and each decode step's;
* each attention layer's K and V at the prompt's rows and at the decode
  steps' rows (they carry every earlier layer, the decode rows each
  earlier step's);
* each mamba layer's final SSM state, and per (layer, head) over the
  mamba layers before the first attention layer;
* each MoE block's output (the routed experts') at the prompt's rows, the
  largest over the layers, and at the decode steps' rows, over all layers
  and steps at once (where a decode step routes 8 tokens, an expert the
  capacity path would cap at 2 assignments takes 3 or more).

The control (``check(control=True)``) puts the reference with every sum
held in bf16 in the program's place, on prompts and continuations drawn
from the seed; ``readings(stand_in={'act': torch.bfloat16})`` gives the
witness, the reference at the configuration's own precision.

Traffic parameters: ``batch``, ``prompt_tokens``, ``new_tokens``,
``check_requests``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from nspubench.generators import derived_seed
from nspubench.generators import lm_batch
from nspubench.reference import granite4h as ref

READINGS = lm_batch.READINGS + ("moe_prompt_rel", "moe_decode_rel")
# The limits hold the readings the configuration's precision decides
# (PERF.md, section 6, PR 31): each lies near the geometric mean of the
# program's largest reading over 19 seeds on the card and the control's
# smallest (every sum in bf16), about 1.3-2x from each; the witness (bf16
# activations, f32 sums) reads as the program does.  On the CPU (the
# tests) the program runs in f32 against the float64 reference.
LIMITS = {
    "bfloat16": {"prefill_logits_rel": 0.13, "decode_logits_rel": 0.19,
                 "kv_prompt_rel": 0.12, "kv_decode_rel": 0.18, "ssm_state_rel": 0.29,
                 "ssm_state_head_rel_early": 0.175, "moe_prompt_rel": 0.3,
                 "moe_decode_rel": 0.3, "failed": 0},
    "float32": {k: 1e-4 for k in READINGS} | {"failed": 0},
}


class Generator(lm_batch.Generator):
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        super().__init__(config, traffic, seed, device, seconds)
        self.limits = LIMITS[self.dtype]
        self.mamba_before = config["layer_types"].index("attention")

    # -- set-up -----------------------------------------------------------
    def _weights(self) -> None:
        self.state = ref.LazyState(self.conf, derived_seed(self.seed, 1), self.device,
                                   getattr(torch, self.dtype))

    def setup(self) -> None:
        from repro_torch.models import granite4h
        from repro_torch.models import transformer as T

        self._weights()
        self.cfg = granite4h.config_from_hf(self.conf, self.conf.get("name", "granite4h"),
                                            self.dtype)
        self.model = T.params_from_hf(self.state, self.cfg, self.device)
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        # warm every shape: one whole batch on prompts no window uses,
        # keeping as many rows as a window's batch may (the kept rows' taps
        # are the largest transients after the weights)
        self._serve(self._prompts(2**20), keep=list(range(min(self.k, self.B))))

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> None:
        from repro_torch import obs

        rng = np.random.default_rng(derived_seed(self.seed, 3))
        self.slots: list = [None] * self.k  # (request index, its outputs)
        self.lat: list = []
        self.failed = 0
        n = 0
        obs.reset()
        obs.enable()
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < seconds:
                i = n // self.B
                # reservoir sampling over the requests, as lm_batch's
                take = {}
                for r in range(self.B):
                    j = n + r if n + r < self.k else int(rng.integers(0, n + r + 1))
                    if j < self.k:
                        take[j] = r
                prompts = self._prompts(i)
                rows = sorted(set(take.values()))
                t_sub = time.perf_counter()
                try:
                    res = self._serve(prompts, rows)
                except Exception:  # noqa: BLE001 - a failed batch fails its requests
                    res = None
                t_done = time.perf_counter()
                if res is None:
                    self.failed += self.B
                self.lat += [t_done - t_sub if res is not None else lm_batch.NEVER_S] * self.B
                if res is not None:
                    for j, r in take.items():
                        q = rows.index(r)
                        self.slots[j] = (n + r, dict(
                            prompt=prompts[r].cpu(), tokens=torch.from_numpy(res.generations[r]),
                            prefill=res.prefill_logits[r].clone(),
                            steps=res.step_logits[q].clone(),
                            cache={name: t[:, q].clone() for name, t in res.kept_cache.items()},
                            moe=res.kept_taps["moe"][q].clone(),
                            moe_decode=res.kept_taps["moe_decode"][q].clone()))
                n += self.B
                del res
        finally:
            obs.disable()
        self.elapsed = time.perf_counter() - t0
        self.requests = n
        self.snapshot = obs.snapshot()
        self.card = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                     else "cpu")

    # -- the comparison ---------------------------------------------------
    def _reference(self, seq: torch.Tensor, **kw) -> dict:
        """The reference's logits, K and V, final SSM states and MoE block
        outputs over ``seq``, as ``_outputs`` gives the program's; its
        weights drawn again as each layer reads them."""
        on_card = self.device.type == "cuda"
        taps: dict = {}
        self._weights()
        lg = ref.forward(self.state, self.conf, seq[None].to(self.device),
                         ssd="quadratic" if on_card else "recurrence",
                         dtype=torch.float32 if on_card else torch.float64, taps=taps, **kw)[0]
        return dict(prefill=lg[: self.S], decode=lg[self.S:], k=[t[0] for t in taps["k"]],
                    v=[t[0] for t in taps["v"]], S=[t[0] for t in taps["S"]],
                    moe=[t[0, : self.S] for t in taps["moe"]],
                    moe_decode=[t[0, self.S:] for t in taps["moe"]])

    def _outputs(self, out: dict) -> dict:
        got = super()._outputs(out)
        got["moe"], got["moe_decode"] = list(out["moe"]), list(out["moe_decode"])
        return got

    def readings(self, stand_in=None) -> dict:
        """The largest of each reading over the checked requests: the
        program's outputs against the reference's, or (``stand_in``, the
        reference's keyword arguments: {'acc': bf16} the control, {'act':
        bf16} the witness) the reference's so computed in the program's
        place."""
        worst = dict.fromkeys(READINGS, 0.0)
        for _, out in (s for s in self.slots if s is not None):
            seq = torch.cat([out["prompt"], out["tokens"][: self.new - 1]])
            want = self._reference(seq)
            got = self._reference(seq, **stand_in) if stand_in else self._outputs(out)
            for k, v in compare(got, want, self.S, self.mamba_before).items():
                worst[k] = max(worst[k], v)
            del want, got
        return worst

    def _counts(self) -> dict:
        """The window's SSD scan launches (one a mamba layer and prefill)
        and its model FLOPs, from the configuration and the traffic."""
        batches = self.requests // self.B
        d = ref.dims(self.conf)
        one = dict(b=self.B, L=self.S, H=d["H"], G=d["G"], N=d["N"], dh=d["P"],
                   chunk=int(self.conf["mamba_chunk_size"]))
        mamba = self.conf["layer_types"].count("mamba")
        return {"ssd_scan": [one] * (mamba * batches),
                "ops": batches * model_flops(self.conf, self.B, self.S, self.new)}


def model_flops(conf: dict, B: int, S: int, new: int) -> int:
    """Model FLOPs of one batch: 2 a matmul parameter a token touches (the
    mamba and attention layers' projections, each layer's router, its
    top-k experts and shared expert, the tied head), attention (4 x query
    width a causal query-key pair, each attention layer), and the SSD's
    dual form in chunks for the prompt (as ``lm_batch.model_flops``), its
    recurrence's state update and read-out for each decoded token."""
    d = dims = ref.dims(conf)
    D, Di, H, P, G, N = d["D"], d["Di"], d["H"], d["P"], d["G"], d["N"]
    hq, hkv = dims["heads"] * dims["hd"], dims["kv_heads"] * dims["hd"]
    kinds = conf["layer_types"]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    q = conf["mamba_chunk_size"]
    mamba = D * (Di + d["conv"] + H) + Di * D
    attn = 2 * D * hq + 2 * D * hkv
    ffn = D * d["E"] + d["k"] * 3 * D * d["F"] + 3 * D * d["Fs"]
    params = n_mamba * mamba + n_attn * attn + d["L"] * ffn + D * d["V"]
    steps = new - 1
    mat = 2 * params * B * (S + steps)
    pre_pairs = S * (S + 1) // 2
    dec_pairs = sum(S + s + 1 for s in range(steps))
    att = 4 * hq * n_attn * B * (pre_pairs + dec_pairs)
    ssd_pre = n_mamba * B * S * (2 * q * N * G + 2 * q * P * H + 4 * N * P * H)
    ssd_dec = n_mamba * B * steps * 4 * N * P * H
    return int(mat + att + ssd_pre + ssd_dec)


def compare(got: dict, want: dict, S: int, early: int) -> dict:
    """The readings of one request (``READINGS``) from its outputs and the
    reference's: ``lm_batch.compare``'s (``early``, the mamba layers before
    the first attention layer, in place of its first hybrid id) and the
    MoE blocks' outputs on the prompt and at the decode steps."""
    out = lm_batch.compare(got, want, S, early)
    out["moe_prompt_rel"] = max(float(lm_batch._rel(g, w))
                                for g, w in zip(got["moe"], want["moe"]))
    # one norm over every layer and step: a decode step's token repeats, so
    # a top-k tie that bf16 rounding breaks the other way holds for every
    # step of its layer and would dominate that layer's own reading
    out["moe_decode_rel"] = float(lm_batch._rel(torch.stack(got["moe_decode"]),
                                                torch.stack(want["moe_decode"])))
    return out
