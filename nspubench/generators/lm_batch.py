"""Closed loop of batched LM requests through the port's serving path
(``repro_torch.launch.serve.serve``: ``transformer.prefill``, then greedy
``transformer.decode_step``), one client, batches back to back until the
window has passed.

Each batch is ``batch`` prompts of ``prompt_tokens`` token ids drawn
uniformly over the vocabulary from the seed (batch i from its own derived
seed), and ``new_tokens`` greedily decoded tokens a prompt.  A request is
timed from the submission of its batch to the return of the call that
produced its last token.  The weights are drawn by the configuration's
published init rule (``reference.zamba2.init_state``) and loaded by the
program's loader of the published parameter names
(``transformer.params_from_hf``).  The program's tracer (``repro_torch.obs``)
is on over the window; its snapshot reaches the per-layer readers through
``summary()['work']['obs']``.

``correct``: ``check_requests`` requests are drawn from the seed among the
window's (reservoir sampling as batches come, so only theirs are kept on
the device: their logits and their rows of the final cache).  For each,
the reference's full forward over the prompt plus the program's own
greedy tokens (teacher forcing) gives logits at every position, each
shared-block application's K and V at every position and each mamba
layer's final SSM state.  Compared with the program's (``READINGS``):

* the prefill logits at every prompt position and each decode step's
  logits: the relative error ||got - want|| / ||want||;
* each application's K and V, at the prompt's rows and at the decode
  steps' rows: the largest relative error over the applications.  An
  application's K and V are functions of its input, concat[h, x0], so
  they carry every earlier layer: the SSM's state, the earlier
  applications' attention, adapter and linear, and at the decode rows
  each earlier decode step's;
* each layer's final SSM state (after the prompt and every decode step
  but the last): the largest relative error over the layers; and over
  the (layer, head) pairs of the layers before the first application,
  whose error is a few layers' rounding and not the depth's: a state not
  carried between the prompt's chunks shows there, since under the
  published init only a few slow heads carry a state across a chunk.

The weights are dropped after the program has loaded them and drawn again
from the seed after ``release()``.  The control (``check(control=True)``)
puts the reference with every sum held in bf16 in the program's place,
on prompts and continuations drawn from the seed; ``readings(stand_in=
{'act': torch.bfloat16})`` gives the witness, the reference at the
configuration's own precision (bf16 activations, f32 sums), which says
what bf16 rounding alone does.

Traffic parameters: ``batch``, ``prompt_tokens``, ``new_tokens``,
``check_requests``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from nspubench.generators import derived_seed, quantile
from nspubench.reference import zamba2 as ref

# The readings, each a largest error (see the docstring); the limits hold
# the ones the configuration's precision decides (PERF.md, section 6: the
# program's readings over its seeds, the witness's, the control's and
# those of faults planted on the card).  On the CPU (the tests) the
# program runs in f32 against the float64 reference.
READINGS = ("prefill_logits_rel", "decode_logits_rel", "kv_prompt_rel", "kv_decode_rel",
            "ssm_state_rel", "ssm_state_head_rel_early")
LIMITS = {
    "bfloat16": {"prefill_logits_rel": 0.36, "decode_logits_rel": 0.38,
                 "kv_prompt_rel": 0.36, "kv_decode_rel": 0.37, "ssm_state_rel": 0.95,
                 "ssm_state_head_rel_early": 0.09, "failed": 0},
    "float32": {"prefill_logits_rel": 1e-4, "decode_logits_rel": 1e-4,
                "kv_prompt_rel": 1e-4, "kv_decode_rel": 1e-4, "ssm_state_rel": 1e-4,
                "ssm_state_head_rel_early": 1e-4, "failed": 0},
}
NEVER_S = 1e9


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        self.conf, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.B = int(traffic["batch"])
        self.S = int(traffic["prompt_tokens"])
        self.new = int(traffic["new_tokens"])
        self.k = int(traffic["check_requests"])
        self.dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        self.limits = LIMITS[self.dtype]
        self.state = None

    # -- set-up -----------------------------------------------------------
    def _weights(self) -> None:
        self.state = ref.init_state(self.conf, derived_seed(self.seed, 1), self.device,
                                    getattr(torch, self.dtype))

    def _prompts(self, i: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, 2, i))
        return torch.randint(0, int(self.conf["vocab_size"]), (self.B, self.S), generator=g,
                             device=self.device)

    def setup(self) -> None:
        from repro_torch.models import transformer as T
        from repro_torch.models import zamba2

        self._weights()
        self.cfg = zamba2.config_from_hf(self.conf, self.conf.get("name", "zamba2"), self.dtype)
        self.model = T.params_from_hf(self.state, self.cfg, self.device)
        # the program holds its own copy; the reference draws them again
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        # warm every shape: one whole batch on prompts no window uses
        self._serve(self._prompts(2**20), keep=[0])

    def _serve(self, prompts: torch.Tensor, keep):
        from repro_torch.launch import serve as serve_lib

        return serve_lib.serve(self.cfg, tokens=self.new, device=self.device,
                               model=self.model, prompts=prompts, keep=keep or None)

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
                # reservoir sampling over the requests: which of this batch's
                # rows take a slot, decided before the batch runs
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
                # a failed request counts as never served
                self.lat += [t_done - t_sub if res is not None else NEVER_S] * self.B
                if res is not None:
                    for j, r in take.items():
                        q = rows.index(r)
                        self.slots[j] = (n + r, dict(
                            prompt=prompts[r].cpu(), tokens=torch.from_numpy(res.generations[r]),
                            prefill=res.prefill_logits[r].clone(),
                            steps=res.step_logits[q].clone(),
                            cache={name: t[:, q].clone() for name, t in res.kept_cache.items()}))
                n += self.B
                del res
        finally:
            obs.disable()
        self.elapsed = time.perf_counter() - t0
        self.requests = n
        self.snapshot = obs.snapshot()
        self.card = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                     else "cpu")

    def summary(self) -> dict:
        lat = self.lat
        n = self.requests
        served = n - self.failed
        batches = n // self.B
        return dict(
            metrics={"serve_p50_ms": 1e3 * quantile(lat, 0.5),
                     "serve_p95_ms": 1e3 * quantile(lat, 0.95),
                     "served_per_s": served / self.elapsed},
            attempted=n, failed=self.failed,
            work={"requests": n, "batches": batches, "window_s": self.elapsed,
                  "tokens_prefilled": batches * self.B * self.S,
                  "tokens_decoded": batches * self.B * (self.new - 1),
                  "obs": self.snapshot, "lm": self._shape(batches)})

    def _shape(self, batches: int) -> dict:
        return dict(card=self.card, batches=batches, batch=self.B, prompt=self.S,
                    new=self.new, conf=self.conf)

    def release(self) -> None:
        self.model = None

    # -- the comparison ---------------------------------------------------
    def plan_control(self, seconds: float) -> None:
        """``check_requests`` prompts with continuations drawn from the
        seed, without running the program."""
        g = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, 4))
        V = int(self.conf["vocab_size"])
        self.slots = [(j, dict(prompt=torch.randint(0, V, (self.S,), generator=g,
                                                    device=self.device).cpu(),
                               tokens=torch.randint(0, V, (self.new,), generator=g,
                                                    device=self.device).cpu()))
                      for j in range(self.k)]
        self.failed, self.requests, self.card = 0, 0, "control"

    def _reference(self, seq: torch.Tensor, **kw) -> dict:
        """The reference's logits, K and V and final SSM states over ``seq``,
        as ``_outputs`` gives the program's."""
        if self.state is None:
            self._weights()
        on_card = self.device.type == "cuda"
        taps: dict = {}
        lg = ref.forward(self.state, self.conf, seq[None].to(self.device),
                         ssd="quadratic" if on_card else "recurrence",
                         dtype=torch.float32 if on_card else torch.float64, taps=taps, **kw)[0]
        return dict(prefill=lg[: self.S], decode=lg[self.S:], k=[t[0] for t in taps["k"]],
                    v=[t[0] for t in taps["v"]], S=[t[0] for t in taps["S"]])

    def _outputs(self, out: dict) -> dict:
        """A checked request's outputs: logits, each application's K and V
        at the positions the reference sees, each layer's final SSM state."""
        T = self.S + self.new - 1
        c = out["cache"]
        return dict(prefill=out["prefill"], decode=out["steps"],
                    k=list(c["k"][:, :T]), v=list(c["v"][:, :T]), S=list(c["S"]))

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
            for k, v in compare(got, want, self.S, self.conf["hybrid_layer_ids"][0]).items():
                worst[k] = max(worst[k], v)
            del want, got
        return worst

    def check(self, full: bool, control: bool = False) -> dict:
        got = self.readings({"acc": torch.bfloat16} if control else None)
        got["failed"] = self.failed
        return dict(checks={k: (got[k], self.limits[k]) for k in self.limits},
                    counts=self._counts())

    def _counts(self) -> dict:
        """The window's head-dim-224 flash launches and its model FLOPs,
        from the configuration and the traffic."""
        batches = self.requests // self.B
        launches = []
        for _ in range(batches):
            launches += self._launches()
        return {"flash_attention": launches,
                "ops": batches * model_flops(self.conf, self.B, self.S, self.new)}

    def _launches(self) -> list:
        c = self.conf
        h, d = c["num_attention_heads"], 2 * c["hidden_size"] // c["num_attention_heads"]
        apps = len(c["hybrid_layer_ids"])
        one = dict(b=self.B, h=h, d=d)
        out = [dict(one, sq=self.S, skv=self.S, causal=True)] * apps
        for s in range(self.new - 1):  # a decode step sees its prefix and itself
            out += [dict(one, sq=1, skv=self.S + s + 1, causal=False)] * apps
        return out


def model_flops(conf: dict, B: int, S: int, new: int) -> int:
    """Model FLOPs of one batch: 2 a matmul parameter touched per token
    (every mamba layer, all the shared-block applications with their
    adapters and linears, the tied head), attention (4 x attention width a
    causal query-key pair, each application), and the SSD's dual form in
    chunks (C B^T per group, the masked product over the chunk and the
    chunk states per head) for the prompt; the recurrence's state update
    and read-out per head for each decoded token."""
    d = ref.dims(conf)
    D, Di, H, P, G, N = d["D"], d["Di"], d["H"], d["P"], d["G"], d["N"]
    F, r, hd, V = d["F"], d["r"], d["heads"] * d["hd"], d["V"]
    L, apps, q = conf["num_hidden_layers"], len(conf["hybrid_layer_ids"]), conf["chunk_size"]
    mamba = D * (Di + d["conv"] + H) + Di * D
    shared = 2 * D * 3 * hd + hd * D + D * 2 * F + F * D + D * r + r * 2 * F + D * D
    params = L * mamba + apps * shared + D * V
    steps = new - 1
    tokens = B * (S + steps)
    mat = 2 * params * tokens
    pre_pairs = S * (S + 1) // 2
    dec_pairs = sum(S + s + 1 for s in range(steps))
    attn = 4 * hd * apps * B * (pre_pairs + dec_pairs)
    ssd_pre = L * B * S * (2 * q * N * G + 2 * q * P * H + 4 * N * P * H)
    ssd_dec = L * B * steps * 4 * N * P * H
    return int(mat + attn + ssd_pre + ssd_dec)


def _rel(got: torch.Tensor, want: torch.Tensor, dims=None) -> torch.Tensor:
    """||got - want|| / ||want|| (over ``dims``, or all), in float64."""
    w = want.to(torch.float64)
    d = got.to(device=w.device, dtype=torch.float64) - w
    n = (lambda x: torch.linalg.vector_norm(x, dim=dims)) if dims else torch.linalg.vector_norm
    return n(d) / n(w)


def compare(got: dict, want: dict, S: int, first: int) -> dict:
    """The readings of one request (``READINGS``) from its outputs and the
    reference's (``Generator._outputs``); ``first``: the first hybrid
    layer id."""
    out = {}
    for part in ("prefill", "decode"):
        w, g = want[part], got[part]
        out[f"{part}_logits_rel"] = float(_rel(g[:, : w.shape[-1]], w))
    for rows, name in ((slice(None, S), "kv_prompt_rel"), (slice(S, None), "kv_decode_rel")):
        out[name] = max(float(_rel(g[rows], w[rows]))
                        for t in ("k", "v") for g, w in zip(got[t], want[t]))
    out["ssm_state_rel"] = max(float(_rel(g, w)) for g, w in zip(got["S"], want["S"]))
    out["ssm_state_head_rel_early"] = max(float(_rel(g, w, dims=(-2, -1)).max())
                                          for g, w in zip(got["S"][:first], want["S"][:first]))
    return out
