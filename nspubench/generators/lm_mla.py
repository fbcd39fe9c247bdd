"""Closed loop of batched LM requests to DeepSeek-V3's block as published
(Kanana-2-30B-A3B-Instruct: latent attention, the sigmoid-routed MoE)
through the port's serving path (``repro_torch.launch.serve.serve``:
``transformer.prefill``, a row at a time, then greedy decode steps as one
CUDA graph on the card), one client, batches back to back until the window
has passed.

Each batch is ``batch`` prompts of ``prompt_tokens`` token ids drawn
uniformly over the vocabulary from the seed (batch i from its own derived
seed), and ``new_tokens`` greedily decoded tokens a prompt.  A request is
timed from the submission of its batch to the return of the call that
produced its last token.  The weights are drawn by the configuration's
published init rule, each tensor from its own generator
(``reference.deepseek_v3.LazyState``), and loaded tensor by tensor by the
program's loader of the published parameter names
(``transformer.params_from_hf``).  The program's tracer
(``repro_torch.obs``) is on over the window; its snapshot reaches the
per-layer readers through ``summary()['work']['obs']``.

The prefill keeps its logits at ``compare_positions`` prompt positions
only (``serve``'s ``prefill_at``): the prompt's last half of them and as
many drawn from the seed among the others, the same for every request of
a run (every position's logits of a 4 x 32,704 batch would be 33.6 GB).

``correct``: ``check_requests`` requests are drawn from the seed among the
window's, as ``lm_batch`` draws them (only theirs are kept on the device:
their logits, their latent rows at the compared positions and at the
decode steps', each MoE block's output there, and each MoE block's
chosen experts at every position).  For each, the reference's full
forward over the prompt plus the program's own greedy tokens (teacher
forcing), each MoE block forced to the program's chosen experts (teacher
forcing of the routing: under the published init a top-6 choice among
128 near-equal sigmoid scores flips on a bf16 rounding, each flip moves
the next layers' inputs, and unforced the last layers of the program and
of the witness read ~0.6 of the logits and ~1.05 of the MoE outputs,
where a fault confined to the deep layers could hide), its weights drawn
again one layer at a time, gives logits, each layer's latent rows and
each MoE block's output at those positions.  Compared with the program's
(``READINGS``, each a largest relative error ||got - want|| / ||want||):

* the prefill logits at the compared positions and each decode step's;
* each layer's latent rows (c after its norm, k_pe after RoPE) at the
  compared prompt positions and at the decode steps' rows (they carry
  every earlier layer, the decode rows each earlier step's);
* each MoE block's output (the routed experts') at the compared prompt
  positions, the largest over the layers, and at the decode steps' rows,
  over all layers and steps at once (as ``lm_granite``);
* the latent rows of the layers no MoE block's output has reached yet
  (layers 0 .. ``first_k_dense_replace``), at the prompt's and the decode
  steps' rows;
* the first MoE block's gates (scattered over the 128 experts) at the
  compared prompt positions where the program and the reference choose
  the same 6 experts: the router's arithmetic (the unbiased scores
  normalised and scaled);
* ``route_differ``: the share of the MoE blocks' tokens (every position
  of the sequence, every MoE layer) at which the reference's own top 6 of
  score + bias is another set than the program's choice: the choice's
  arithmetic, which the forcing takes out of the other readings.

The control (``check(control=True)``) puts the reference with every sum
held in bf16 in the program's place, on prompts and continuations drawn
from the seed; ``readings(stand_in={'act': torch.bfloat16})`` gives the
witness, the reference at the configuration's own precision.

Traffic parameters: ``batch``, ``prompt_tokens``, ``new_tokens``,
``check_requests``, ``compare_positions``.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from nspubench.generators import derived_seed
from nspubench.generators import lm_batch
from nspubench.reference import deepseek_v3 as ref

READINGS = ("prefill_logits_rel", "decode_logits_rel", "latent_prompt_rel",
            "latent_decode_rel", "moe_prompt_rel", "moe_decode_rel", "latent_prompt_rel_early",
            "latent_decode_rel_early", "gates_rel_first", "route_differ")
# The limits hold the readings the configuration's precision decides
# (PERF.md, section 6): each lies near the geometric mean of the
# program's largest reading on the card (8 seeds) and the control's
# smallest (every sum in bf16, on the program's routing; it reads over
# every limit); the witness (bf16 activations, f32 sums) reads as the
# program does.  With the routing forced every reading is a few
# roundings: the program reads 0.034-0.038 of the logits and of every
# layer's latent rows, 0.05 of the MoE outputs, the control 3.8-3.9 times
# that; ``route_differ`` reads 14.5-14.9% of the choices (the witness
# 16.0%, the control 51%).  On the CPU (the tests) the program runs in
# f32 against the float64 reference.
LIMITS = {
    "bfloat16": {"prefill_logits_rel": 0.070, "decode_logits_rel": 0.072,
                 "latent_prompt_rel": 0.070, "latent_decode_rel": 0.072,
                 "moe_prompt_rel": 0.10, "moe_decode_rel": 0.077,
                 "latent_prompt_rel_early": 0.016, "latent_decode_rel_early": 0.016,
                 "gates_rel_first": 0.0022, "route_differ": 0.28, "failed": 0},
    "float32": {k: 1e-4 for k in READINGS} | {"failed": 0},
}


class Generator(lm_batch.Generator):
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        super().__init__(config, traffic, seed, device, seconds)
        self.limits = LIMITS[self.dtype]
        n = int(traffic["compare_positions"])
        last = n // 2
        rng = np.random.default_rng(derived_seed(self.seed, 5))
        drawn = rng.choice(self.S - last, size=n - last, replace=False)
        # the compared prompt positions, ascending: drawn ones, then the last
        self.at = sorted(int(p) for p in drawn) + list(range(self.S - last, self.S))

    # -- set-up -----------------------------------------------------------
    def _weights(self) -> None:
        self.state = ref.LazyState(self.conf, derived_seed(self.seed, 1), self.device,
                                   getattr(torch, self.dtype))

    def setup(self) -> None:
        from repro_torch.models import deepseek_v3
        from repro_torch.models import transformer as T

        t0 = time.perf_counter()
        self._weights()
        self.cfg = deepseek_v3.config_from_hf(self.conf, self.conf.get("name", "deepseek_v3"),
                                              self.dtype)
        self.model = T.params_from_hf(self.state, self.cfg, self.device)
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        # warm every shape the window runs: the prefill goes a row at a
        # time, every row the same shapes, so one row (on a prompt no
        # window uses, its taps kept) and a decode step; then the decode
        # graph at the window's batch, captured after its own warm-up step
        self._serve(self._prompts(2**20)[:1], keep=[0], tokens=2)
        t2 = time.perf_counter()
        if self.device.type == "cuda":
            with torch.inference_mode():  # as serve captures it
                deepseek_v3.decode_graph(self.model, self.B, self.S + self.new + 1)
        t3 = time.perf_counter()
        print(f"lm_mla: set-up weights {t1 - t0:.3f} s, a row's prefill and a step "
              f"{t2 - t1:.3f} s, the decode graph {t3 - t2:.3f} s", file=sys.stderr, flush=True)

    def _serve(self, prompts: torch.Tensor, keep, tokens=None):
        from repro_torch.launch import serve as serve_lib

        return serve_lib.serve(self.cfg, tokens=tokens or self.new, device=self.device,
                               model=self.model, prompts=prompts, keep=keep or None,
                               prefill_at=self.at)

    def release(self) -> None:
        """The program's weights and its decode graph (with its 7.4 GB latent
        cache) leave the card before the reference's check."""
        if self.model is not None:
            self.model.__dict__.pop("_decode_graph", None)
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            print(f"lm_mla: {torch.cuda.memory_allocated(self.device)} B allocated after "
                  "the release", file=sys.stderr, flush=True)

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
                            latent=res.kept_cache["latent"][:, q].clone(),
                            moe=res.kept_taps["moe"][q].clone(),
                            gates=res.kept_taps["gates"][q, 0].clone(),
                            moe_decode=res.kept_taps["moe_decode"][q].clone(),
                            route=torch.cat([res.kept_taps["route"][q],
                                             res.kept_taps["route_decode"][q].to(torch.int16)],
                                            dim=1)))
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
    def _positions(self) -> torch.Tensor:
        """The compared positions of a request's sequence: the prompt's,
        then every decode step's input row."""
        return torch.tensor(self.at + list(range(self.S, self.S + self.new - 1)))

    def _reference(self, seq: torch.Tensor, route=None, **kw) -> dict:
        """The reference's logits, latent rows and MoE block outputs at the
        compared positions of ``seq``, as ``_outputs`` gives the program's;
        its weights drawn again as each layer reads them; 'route', each MoE
        block's chosen experts [L_moe, len(seq), k].  ``route`` (so shaped):
        each MoE block's chosen experts, forced; 'differ' is then the share
        of the MoE blocks' tokens whose own choice was another set."""
        on_card = self.device.type == "cuda"
        taps: dict = {}
        self._weights()
        lg = ref.forward(self.state, self.conf, seq[None].to(self.device),
                         dtype=torch.float32 if on_card else torch.float64, taps=taps,
                         at=self._positions(),
                         route=None if route is None else [r[None] for r in route], **kw)[0]
        self.state = None
        n = len(self.at)
        differ = (0.0 if route is None else
                  sum(taps["route_differ"]) / (route.shape[0] * route.shape[1]))
        return dict(prefill=lg[:n], decode=lg[n:], latent=[t[0] for t in taps["latent"]],
                    moe=[t[0, :n] for t in taps["moe"]],
                    moe_decode=[t[0, n:] for t in taps["moe"]], gates=taps["gates"][0][0, :n],
                    differ=differ, route=torch.stack([t[0] for t in taps["route"]]))

    def _outputs(self, out: dict) -> dict:
        return dict(prefill=out["prefill"], decode=out["steps"], latent=list(out["latent"]),
                    moe=list(out["moe"]), moe_decode=list(out["moe_decode"]),
                    gates=out["gates"])

    def readings(self, stand_in=None) -> dict:
        """The largest of each reading over the checked requests: the
        program's outputs against the reference's, or (``stand_in``, the
        reference's keyword arguments: {'acc': bf16} the control, {'act':
        bf16} the witness) the reference's so computed in the program's
        place."""
        return self.readings_of([stand_in])[0]

    def readings_of(self, stand_ins) -> list:
        """``readings`` of each of ``stand_ins`` (None: the program), the
        reference computed once a request for them all.  Where the program
        ran, the reference and every stand-in take its routing (teacher
        forcing, as of its tokens: a top-6 choice among 128 near-equal
        sigmoid scores flips on a rounding, and a flip moves every later
        layer), and 'route_differ' reads how many of the MoE blocks' tokens
        would choose other experts of their own: the reference's choice
        against the program's, a stand-in's against the program's.  Where
        it did not (``plan_control``), the reference's own routing takes the
        program's part."""
        worst = [dict.fromkeys(READINGS, 0.0) for _ in stand_ins]
        early = int(self.conf["first_k_dense_replace"]) + 1
        for _, out in (s for s in self.slots if s is not None):
            seq = torch.cat([out["prompt"], out["tokens"][: self.new - 1]])
            route = out.get("route")
            want = self._reference(seq, route)
            route = want.pop("route") if route is None else route
            for w, stand_in in zip(worst, stand_ins):
                if stand_in:
                    got = self._reference(seq, route, **stand_in)
                else:
                    got = dict(self._outputs(out), differ=want["differ"])
                for k, v in compare(got, want, len(self.at), early).items():
                    w[k] = max(w[k], v)
                del got
            del want
        return worst

    def _counts(self) -> dict:
        """The window's MLA flash launches (one a layer and prompt row: the
        prefill runs a row at a time) and its model FLOPs, from the
        configuration and the traffic."""
        batches = self.requests // self.B
        c = self.conf
        one = dict(b=1, sq=self.S, skv=self.S, h=c["num_attention_heads"],
                   dqk=c["qk_nope_head_dim"] + c["qk_rope_head_dim"], dv=c["v_head_dim"],
                   causal=True)
        return {"flash_mla": [one] * (c["num_hidden_layers"] * self.B * batches),
                "ops": batches * model_flops(c, self.B, self.S, self.new, len(self.at) + 1)}


def model_flops(conf: dict, B: int, S: int, new: int, head_rows: int) -> int:
    """Model FLOPs of one batch: 2 a matmul parameter a token touches (each
    layer's MLA projections (``kv_b_proj``'s per-head K and V rows, which
    the decode's absorbed form applies to q and to the latent output),
    the dense SwiGLU or the router, the top-k routed experts and the shared
    experts), the head at the positions computed (``head_rows`` a prompt,
    every decode step), 2 (192 + 128) a causal query-key pair a head at
    prefill, and 2 x 576 + 2 x 512 a cached row a head at each decode
    step (the scores over [c, k_pe], then c weighted)."""
    d = ref.dims(conf)
    D, H, r, dr, E = d["D"], d["H"], d["r"], d["dr"], d["E"]
    dqk, dv = d["dn"] + dr, d["dv"]
    mla = D * H * dqk + D * (r + dr) + r * H * (d["dn"] + dv) + H * dv * D
    moe = D * E + d["k"] * 3 * D * d["Fe"] + 3 * D * d["Fs"]
    params = d["L"] * mla + d["dense"] * 3 * D * d["F"] + (d["L"] - d["dense"]) * moe
    steps = new - 1
    mat = 2 * params * B * (S + steps) + 2 * D * d["V"] * B * (head_rows + steps)
    pairs = S * (S + 1) // 2
    pre = 2 * (dqk + dv) * H * d["L"] * B * pairs
    rows = sum(S + s + 1 for s in range(steps))
    dec = (2 * (r + dr) + 2 * r) * H * d["L"] * B * rows
    return int(mat + pre + dec)


def compare(got: dict, want: dict, n: int, early: int) -> dict:
    """The readings of one request (``READINGS``) from its outputs and the
    reference's; ``n``: the compared prompt positions (the latent rows'
    first n are the prompt's); ``early``: the layers no MoE output reaches
    before their latent rows."""
    rel = lm_batch._rel
    out = {}
    for rows, name in ((slice(None, n), "latent_prompt_rel_early"),
                       (slice(n, None), "latent_decode_rel_early")):
        out[name] = max(float(rel(g[rows], w[rows]))
                        for g, w in zip(got["latent"][:early], want["latent"][:early]))
    # the gates where both chose the same experts (a flip is a rounding's
    # choice between near-equal scores, not the router's arithmetic)
    gp, gr = got["gates"].to(torch.float64), want["gates"].to(torch.float64)
    same = ((gp.cpu() != 0) == (gr.cpu() != 0)).all(dim=-1)
    out["gates_rel_first"] = float(rel(gp[same.to(gp.device)], gr[same.to(gr.device)])) \
        if bool(same.any()) else float("inf")
    for part in ("prefill", "decode"):
        w, g = want[part], got[part]
        out[f"{part}_logits_rel"] = float(rel(g[:, : w.shape[-1]], w))
    for rows, name in ((slice(None, n), "latent_prompt_rel"),
                       (slice(n, None), "latent_decode_rel")):
        out[name] = max(float(rel(g[rows], w[rows]))
                        for g, w in zip(got["latent"], want["latent"]))
    out["moe_prompt_rel"] = max(float(rel(g, w)) for g, w in zip(got["moe"], want["moe"]))
    out["route_differ"] = float(got["differ"])
    # one norm over every layer and step, as lm_granite's
    out["moe_decode_rel"] = float(rel(torch.stack(got["moe_decode"]),
                                      torch.stack(want["moe_decode"])))
    return out
