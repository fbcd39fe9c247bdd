"""Optimizers and the gradient-compression transform, on trees of tensors.

Port of the JAX package's ``distributed/optimizer.py``:

* ``AdamW`` — f32 moments, global-norm clip, cosine schedule, decoupled
  weight decay on leaves of ndim >= 2.
* ``Adafactor`` — factored second moments (row/column statistics over the
  last two axes of a leaf of ndim >= 2), bf16 first moment, update clipped
  to RMS <= 1 per leaf.
* ``ErrorFeedbackInt8`` — int8 symmetric per-leaf quantization of the
  gradients with an f32 error-feedback residual in the optimizer state.

A tree is a nested dict of tensors in the JAX package's layout: the
layers' weights are STACKED, one leaf [L, ...] for all layers of a stacked
tree (``transformer.param_tree`` gives the model in that layout).  Every
per-leaf rule therefore acts on the stacked leaf: the stacked norm gammas
[L, D] are decayed and factored over (L, D), and Adafactor's RMS and the
EF scale are one number per stacked leaf, over all layers (and all
experts).  A per-layer tree would change all four rules without error.

Updates are functional (new trees; the inputs are not written), in the
JAX package's order of expressions and dtypes: moments and update math in
f32, bias corrections ``1 - b**t`` in f32, ``rsqrt`` of a max, the
``1e-30`` eps, ``torch.round`` half to even as ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure); anything not a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda o, i=i: o[i], tree) for i in range(n))


@dataclasses.dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clip(
            (step - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.peak_lr * warm * (self.min_ratio + (1 - self.min_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale math in f32; gradients keep their storage dtype."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), n


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _step0(params) -> torch.Tensor:
    return _zeros((), torch.int32, tree_leaves(params)[0])


class AdamW:
    def __init__(
        self,
        schedule: Schedule,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        weight_decay: float = 0.1,
        clip_norm: float = 1.0,
        compressor: Optional["ErrorFeedbackInt8"] = None,
    ):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.eps, self.weight_decay, self.clip_norm = eps, weight_decay, clip_norm
        self.compressor = compressor

    def init(self, params) -> dict:
        z = lambda p: _zeros(p.shape, torch.float32, p)
        state = {"m": tree_map(z, params), "v": tree_map(z, params),
                 "step": _step0(params)}
        if self.compressor is not None:
            state["ef"] = self.compressor.init(params)
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        step = state["step"] + 1
        ef = None
        if self.compressor is not None:
            grads, ef = self.compressor.apply(grads, state["ef"])
        grads, _ = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        bc1, bc2 = 1 - b1**t, 1 - b2**t

        def upd(p, g, mm, vv):
            # moment math in f32 whatever the gradients' storage dtype
            g = g.to(torch.float32)
            mm = b1 * mm + (1 - b1) * g
            vv = b2 * vv + (1 - b2) * torch.square(g)
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                u = u + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), mm, vv

        new_params, m, v = _unzip(tree_map(upd, params, grads, state["m"], state["v"]), 3)
        new_state = {"m": m, "v": v, "step": step}
        if ef is not None:
            new_state["ef"] = ef
        return new_params, new_state


class Adafactor:
    """Factored 2nd-moment optimizer (Shazeer & Stern 2018), bf16 momentum."""

    def __init__(
        self,
        schedule: Schedule,
        b1: float = 0.9,
        decay: float = 0.8,
        eps: float = 1e-30,
        clip_norm: float = 1.0,
        weight_decay: float = 0.0,
        compressor: Optional["ErrorFeedbackInt8"] = None,
    ):
        self.schedule, self.b1, self.decay = schedule, b1, decay
        self.eps, self.clip_norm, self.weight_decay = eps, clip_norm, weight_decay
        self.compressor = compressor

    def _factored(self, p) -> bool:
        return p.ndim >= 2

    def init(self, params) -> dict:
        def vrow(p):
            return _zeros(p.shape[:-1] if self._factored(p) else p.shape,
                          torch.float32, p)

        def vcol(p):
            return _zeros(p.shape[:-2] + p.shape[-1:] if self._factored(p) else (1,),
                          torch.float32, p)

        state = {
            "m": tree_map(lambda p: _zeros(p.shape, torch.bfloat16, p), params),
            "vr": tree_map(vrow, params),
            "vc": tree_map(vcol, params),
            "step": _step0(params),
        }
        if self.compressor is not None:
            state["ef"] = self.compressor.init(params)
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        step = state["step"] + 1
        ef = None
        if self.compressor is not None:
            grads, ef = self.compressor.apply(grads, state["ef"])
        grads, _ = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(step)
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-self.decay)

        def upd(p, g, m, vr, vc):
            g = g.to(torch.float32)
            g2 = g * g + self.eps
            if self._factored(p):
                vr_n = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
                vc_n = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
                denom = (
                    vr_n[..., None]
                    * vc_n[..., None, :]
                    / torch.clamp(vr_n.mean(dim=-1)[..., None, None], min=self.eps)
                )
                u = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
            else:
                vr_n = beta2 * vr + (1 - beta2) * g2
                vc_n = vc
                u = g * torch.rsqrt(torch.clamp(vr_n, min=self.eps))
            # update clipping (RMS <= 1) over the whole leaf
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            m_n = (self.b1 * m.to(torch.float32) + (1 - self.b1) * u).to(torch.bfloat16)
            pw = p.to(torch.float32)
            if self.weight_decay and p.ndim >= 2:
                pw = pw * (1 - lr * self.weight_decay)
            return (pw - lr * m_n.to(torch.float32)).to(p.dtype), m_n, vr_n, vc_n

        out = tree_map(upd, params, grads, state["m"], state["vr"], state["vc"])
        new_params, m, vr, vc = _unzip(out, 4)
        new_state = {"m": m, "vr": vr, "vc": vc, "step": step}
        if ef is not None:
            new_state["ef"] = ef
        return new_params, new_state


class ErrorFeedbackInt8:
    """Int8 symmetric gradient compression with error feedback.

    apply(): g_q = dequant(quant(g + residual)); residual' = (g + residual)
    - g_q, with one scale ``max|x| / 127`` per leaf.
    """

    def init(self, params):
        return tree_map(lambda p: _zeros(p.shape, torch.float32, p), params)

    @staticmethod
    def _q(x: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q.to(torch.float32) * scale

    @torch.no_grad()
    def apply(self, grads, residual):
        def one(g, r):
            acc = g.to(torch.float32) + r
            gq = self._q(acc)
            return gq, acc - gq

        return _unzip(tree_map(one, grads, residual), 2)


def make_optimizer(name: str, schedule: Schedule, compress: bool = False):
    comp = ErrorFeedbackInt8() if compress else None
    if name == "adamw":
        return AdamW(schedule, compressor=comp)
    if name == "adafactor":
        return Adafactor(schedule, compressor=comp)
    raise ValueError(f"unknown optimizer {name!r}")
