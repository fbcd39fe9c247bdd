"""Mixture-of-Experts FFN.

Port of the JAX package's ``models/moe.py``:

* ``moe_reference`` — every expert for every token (O(E) operations; tests
  and tiny smokes only), exact dropless semantics.
* ``moe_apply`` — the capacity path of the JAX package's ids (olmoe-1b-7b,
  kimi-k2 and their smokes, family 'moe'): route (top-k of the router's
  logits, softmax after top-k), then ``moe_local_shard`` with
  ``_local_shard_gathered`` (per-expert capacity slots, batched
  [E_loc, cap_e, D] products; the default) or ``_local_shard_ragged``
  (``moe_impl='ragged'``: sort by expert, one ``torch.matmul`` per group,
  as the JAX package has no kernel here either).  Without a mesh (or
  with a ``model`` axis of size 1) every expert runs on this device, the
  one shard of ``n_shards`` 1.  On a ``DeviceMesh`` it takes the
  expert-parallel branch, the JAX package's ``shard_map``: a
  ``local_map`` over the tokens sharded on the batch axes, the router
  replicated and the experts sharded over ``model``; each rank computes
  its own experts' share (``moe_local_shard`` with its shard index, the
  others' assignments masked to an overflow id) and the shares are
  summed over ``model`` (a ``Partial`` output made ``Replicate``: an
  all-reduce, JAX's ``psum``).
* ``moe_dropless`` — the dropless path of the published Granite 4.0-H
  (``granite-4.0-h-small``, family 'granite4h'; ``models/granite4h.py``),
  as ``GraniteMoeHybridMoE`` computes it: every assignment computed.
  DeepSeek-V3's MoE layers (``kanana-2-30b-a3b-instruct``, family
  'deepseek_v3'; ``models/deepseek_v3.py``) route by ``route_sigmoid``,
  then take ``experts_grouped`` (each expert over its own rows) at
  prefill and ``experts_in_slots``' static form at decode.  Its
  experts keep the published layout (``w_in`` [E, 2 F, D], gate rows
  first, and ``w_out`` [E, D, F]).  Each expert gets as many slots as its
  largest load needs and the SwiGLU runs batched over the experts,
  [E, cap, D]: a prefill reads the largest load on the host (one wait a
  block, no loop over the experts); a decode step (``static=True``: every
  shape fixed, so a CUDA graph captures it) takes cap T, which no expert
  can overflow (a token picks an expert once), and reads every expert's
  weights.

The capacity path drops the assignments beyond an expert's capacity
``cap_e = max(1, round(T k / E cf))`` (Switch/GShard-style), in the JAX
package's order: the position of an assignment in its expert counts the
flat (token, slot) order.  The gathered path has no shape that depends on
the data (a scatter-add counts the experts, the overflow slot takes the
dropped assignments), so it also runs on fake tensors (the dry run).  No
published MoE drops: the dropless path keeps every assignment.

Where JAX relies on its own ordering the port makes it explicit: top-k is
the first k of a stable descending sort (JAX's top-k puts the lower index
first on equal values), the ragged sort is stable (JAX's argsort is), and
capacities use Python's ``round``.  The combine does not scatter-
add (whose order on the card follows atomics): each token gathers its k
slot outputs and sums them in slot order, so a step gives the same bits
from run to run, on both paths.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _acc, _dtype, dense_init


def init_moe(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = _dtype(cfg)
    return {
        "router": dense_init(generator, (D, E), torch.float32, device=device),
        "w_gate": _experts(generator, (E, D, F), dt, device),
        "w_up": _experts(generator, (E, D, F), dt, device),
        "w_down": _experts(generator, (E, F, D), dt, device),
    }


def _experts(generator, shape, dtype, device) -> torch.Tensor:
    """[E, D_in, D_out] expert weights in the JAX package's distribution
    (its ``dense_init`` takes the leading axis, E, as the fan-in: N(0,
    1/E)), drawn one expert at a time so the f32 draw of a 384-expert
    tensor never exists whole."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:  # shapes only (the dry run): nothing to draw
        return out
    scale = math.sqrt(shape[1] / shape[0])  # over dense_init's sqrt(D_in)
    for e in range(shape[0]):
        out[e] = dense_init(generator, shape[1:], dtype, scale, device=device)
    return out


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Softmax-after-topk routing of x [T, D] by ``router`` [D, E]: (probs
    [T, k], ids [T, k] int64, logits [T, E]), the logits and probs in f32
    (float64 for a float64 model).  On equal logits the lower expert id
    comes first, as in JAX's top-k."""
    ct = _acc(router.dtype)
    logits = x.to(ct) @ router.to(ct)  # [T, E]
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), order[:, :top_k], logits


def route_sigmoid(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int,
                  scaling: float):
    """DeepSeek-V3's routing of x [T, D] by ``router`` [D, E] (one group):
    (gates [T, k], ids [T, k] int64, scores [T, E]).  The scores are the
    sigmoid of the f32 logits (float64 for a float64 model); the k experts
    are the top k of scores + ``bias`` (``e_score_correction_bias``, [E]),
    the lower expert id first on equal values; the gates are those
    experts' unbiased scores over their sum (+ 1e-20), times ``scaling``
    (``routed_scaling_factor``), in f32 (as ``DeepseekV3TopkRouter``)."""
    ct = _acc(router.dtype)
    scores = torch.sigmoid(x.to(ct) @ router.to(ct))  # [T, E]
    _, order = torch.sort(scores + bias.to(ct), dim=-1, descending=True, stable=True)
    ids = order[:, :top_k]
    gates = scores.gather(1, ids)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20) * scaling
    return gates, ids, scores


def router_topk(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Softmax-after-topk routing (Mixtral/OLMoE convention).

    x: [T, D] -> (probs [T, k], ids [T, k] int64, aux_loss scalar), probs
    and aux in f32 (float64 for a float64 model), as ``route``.
    """
    ct = _acc(router.dtype)
    probs, ids, logits = route(x, router, top_k)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    E = router.shape[1]
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = torch.nn.functional.one_hot(ids[:, 0], E).to(ct).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return probs, ids, aux


def _silu_glu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(g.to(_acc(g.dtype))).to(g.dtype) * u


def _combine(y_slots: torch.Tensor, slot_of: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each token's k slot outputs summed in slot order: y_slots [n, D] (a
    zero row appended at index n), slot_of [T * k] (n where dropped)."""
    padded = torch.cat([y_slots, y_slots.new_zeros((1, y_slots.shape[1]))])
    return padded[slot_of].reshape(T, k, -1).sum(dim=1)


def capacity_keep(flat_ids: torch.Tensor, n_experts: int,
                  cap_e: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(keep [T*k] bool, position of each assignment in its expert): an
    assignment is kept where it is among the first ``cap_e`` of its expert
    in flat (token, slot) order.  The JAX package counts the positions by a
    cumsum over a [T*k, E] one-hot; its rank in a stable sort by expert
    gives the same integers without the [T*k, E] scan (400 ms of olmoe's
    prefill on the card).  Ids run over [0, n_experts)."""
    n = flat_ids.numel()
    order = torch.argsort(flat_ids, stable=True)
    counts = torch.zeros(n_experts, dtype=flat_ids.dtype, device=flat_ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=0) - counts  # each id's first sorted slot
    pie = torch.empty_like(flat_ids)
    pie[order] = torch.arange(n, device=flat_ids.device) - starts[flat_ids[order]]
    return pie < cap_e, pie


def expert_capacity(T: int, cfg: ArchConfig) -> int:
    """cap_e of the gathered path, with Python's ``round`` (half to even),
    as the JAX package computes it."""
    return int(max(1, round(T * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor)))


def _local_shard_gathered(x, params, cfg, local_ids, flat_probs, local, E_loc):
    """Index-gather dispatch (Switch/GShard semantics, memory- and
    FLOP-exact): per-expert capacity slots, batched [E_loc, cap_e, D]
    products over this shard's ``E_loc`` experts; ``local_ids`` holds
    E_loc (the overflow id) where an assignment is another shard's, and
    assignments beyond an expert's capacity are dropped."""
    T, D = x.shape
    k = cfg.top_k
    cap_e = expert_capacity(T, cfg)
    keep, pie = capacity_keep(local_ids, E_loc + 1, cap_e)
    keep = keep & local
    n_slots = E_loc * cap_e
    dest = torch.where(keep, local_ids * cap_e + pie, n_slots)  # overflow slot
    tok_idx = torch.arange(T * k, device=x.device) // k
    # kept assignments have distinct slots; the rest all land on the
    # overflow slot, which is cut off
    slot_tok = torch.zeros(n_slots + 1, dtype=torch.long, device=x.device)
    slot_used = torch.zeros(n_slots + 1, dtype=torch.bool, device=x.device)
    slot_prob = torch.zeros(n_slots + 1, dtype=flat_probs.dtype, device=x.device)
    slot_tok[dest] = tok_idx
    slot_used[dest] = keep
    slot_prob[dest] = flat_probs
    slot_tok, slot_used, slot_prob = slot_tok[:-1], slot_used[:-1], slot_prob[:-1]
    x_e = x[slot_tok].reshape(E_loc, cap_e, D)
    x_e = x_e * slot_used.reshape(E_loc, cap_e, 1).to(x_e.dtype)
    g = torch.bmm(x_e, params["w_gate"])
    u = torch.bmm(x_e, params["w_up"])
    y_e = torch.bmm(_silu_glu(g, u), params["w_down"])  # [E_loc, cap_e, D]
    w = (slot_prob * slot_used).reshape(E_loc, cap_e, 1).to(y_e.dtype)
    flat_y = (y_e * w).reshape(n_slots, D)
    return _combine(flat_y, dest, T, k)


def _local_shard_ragged(x, params, cfg, local_ids, flat_probs, local, E_loc):
    """Sort by expert (this shard's first, the overflow id last), then one
    grouped SwiGLU per local expert over its rows (``torch.matmul`` per
    group); the first ``cap`` assignments of the sorted order are
    computed, the rest dropped.  Its group sizes are read on the host."""
    T, D = x.shape
    k = cfg.top_k
    cap = int(max(k, round(T * k / max(1, cfg.n_experts // E_loc)
                           * cfg.moe_capacity_factor)))
    cap = min(cap, T * k)
    order = torch.argsort(local_ids, stable=True)
    sel = order[:cap]
    x_sel = x[sel // k]
    sizes = torch.bincount(local_ids[sel], minlength=E_loc + 1)[:E_loc].tolist()
    y_sel = torch.zeros_like(x_sel)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = x_sel[start : start + n]
            h = _silu_glu(rows @ params["w_gate"][e], rows @ params["w_up"][e])
            y_sel[start : start + n] = h @ params["w_down"][e]
        start += n
    y_sel = y_sel * (flat_probs[sel] * local[sel]).to(y_sel.dtype)[:, None]
    pos = torch.full((T * k,), cap, dtype=torch.long, device=x.device)
    pos[sel] = torch.arange(cap, device=x.device)
    return _combine(y_sel, pos, T, k)


def moe_local_shard(x: torch.Tensor, params: dict, cfg: ArchConfig,
                    shard_idx: int = 0, n_shards: int = 1) -> torch.Tensor:
    """Expert compute of model shard ``shard_idx`` of ``n_shards`` over
    local tokens x [T, D]: the expert tensors in ``params`` are the shard's
    [E // n_shards, ...] slices (all experts at one shard).  Returns this
    shard's partial output [T, D] (the caller sums the shards)."""
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // n_shards
    probs, ids, _ = router_topk(x, params["router"], k)
    e_start = shard_idx * E_loc
    flat_ids = ids.reshape(-1)  # [T*k]
    local = (flat_ids >= e_start) & (flat_ids < e_start + E_loc)
    local_ids = torch.where(local, flat_ids - e_start, E_loc)  # E_loc = overflow
    impl = _local_shard_ragged if cfg.moe_impl == "ragged" else _local_shard_gathered
    y = impl(x, params, cfg, local_ids, probs.reshape(-1), local, E_loc)
    return y.to(x.dtype)


def moe_apply(x: torch.Tensor, params: dict, cfg: ArchConfig, mesh=None,
              model_axis: str = "model") -> torch.Tensor:
    """MoE FFN over [B, S, D] activations: on a mesh the expert-parallel
    branch (module docstring; with a ``model`` axis of size 1 its one
    shard computes every expert, as without a mesh), else every expert on
    this device."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if mesh is None:
        return moe_local_shard(xt, params, cfg).reshape(B, S, D)
    return _expert_parallel(xt, params, cfg, mesh, model_axis).reshape(B, S, D)


def _expert_parallel(xt, params, cfg, mesh, model_axis):
    """The JAX package's ``shard_map`` branch as a ``local_map``: in
    placements its in_specs (tokens over the batch axes, router
    replicated, experts over ``model``); gradients come back summed where
    the JAX transpose would ``psum`` them (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import sharding

    names = sharding.axis_names(mesh)
    n_shards = sharding.axis_size(mesh, model_axis) if model_axis in names else 1
    dp = tuple(a for a in names if a != model_axis)
    batch = sharding.fit_axes(xt.shape[0], mesh, dp) or ()

    def pl(on_batch, on_model, other=Replicate()):
        return tuple(on_model if a == model_axis else on_batch if a in batch else other
                     for a in names)

    tok = pl(Shard(0), Replicate())
    rep = pl(Replicate(), Replicate())
    exp = pl(Replicate(), Shard(0))
    out = pl(Shard(0), Partial())

    def shard_fn(x_l, router, w_gate, w_up, w_down):
        p = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        idx = mesh.get_local_rank(model_axis) if n_shards > 1 else 0
        return moe_local_shard(x_l, p, cfg, idx, n_shards)

    y = local_map(
        shard_fn, out_placements=list(out),
        in_placements=(tok, rep, exp, exp, exp),
        in_grad_placements=(pl(Shard(0), Partial()), pl(Partial(), Partial()),
                            pl(Partial(), Shard(0)), pl(Partial(), Shard(0)),
                            pl(Partial(), Shard(0))),
        device_mesh=mesh, redistribute_inputs=True,
    )(xt, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    return y.redistribute(mesh, tok)  # the sum over model: an all-reduce


def expert_loads(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments each expert takes, [E] int64 on ids' device (a
    scatter-add: no host read, no data-dependent shape)."""
    flat = ids.reshape(-1)
    loads = torch.zeros(n_experts, dtype=flat.dtype, device=flat.device)
    return loads.scatter_add_(0, flat, torch.ones_like(flat))


def experts_in_slots(x: torch.Tensor, params: dict, probs: torch.Tensor, ids: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """The SwiGLU experts (the published layout) over x [T, D] for the
    routing (probs, ids) [T, k]: each expert gets ``cap`` slots, filled in
    flat (token, slot) order, and the two products run batched over the
    experts, [E, cap, D] (unused slots are zero rows); each output times
    its gate in x's dtype, a token's k summed in slot order.  An
    assignment past its expert's ``cap`` gives nothing."""
    T, D = x.shape
    E, k = params["w_in"].shape[0], ids.shape[1]
    flat = ids.reshape(-1)
    kept, pie = capacity_keep(flat, E, cap)
    n = E * cap
    dest = torch.where(kept, flat * cap + pie, n)  # one spare slot takes the rest
    slot_tok = torch.zeros(n + 1, dtype=torch.long, device=x.device)
    slot_used = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    slot_tok[dest] = torch.arange(T * k, device=x.device) // k
    slot_used.index_fill_(0, dest, 1)  # a scalar fill: nothing copied from the host
    x_e = x[slot_tok[:n]].mul_(slot_used[:n, None]).reshape(E, cap, D)
    gate, up = torch.bmm(x_e, params["w_in"].transpose(1, 2)).chunk(2, dim=-1)
    del x_e
    y_e = torch.bmm(_silu_glu(gate, up), params["w_out"].transpose(1, 2)).reshape(n, D)
    del gate, up
    gates = (probs.reshape(-1) * kept).to(x.dtype)  # 0 where dropped
    y_slots = y_e[dest.clamp(max=n - 1)].mul_(gates[:, None])
    del y_e
    return y_slots.reshape(T, k, D).sum(dim=1)


def experts_grouped(x: torch.Tensor, params: dict, probs: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """``experts_in_slots``' SwiGLU experts with no slot left empty: the
    assignments sorted by expert (stable: flat (token, slot) order within
    one), each expert's two products over its own rows, each output times
    its gate in x's dtype, a token's k summed in slot order.  Its work
    follows the assignments, where the slots' follows the largest load:
    under a skewed router (one expert taking several times its share) the
    slots are mostly padding.  In bf16 the two products are grouped ones
    over the experts' row offsets (``torch._grouped_mm``, two launches, no
    host read); in another dtype a loop over the experts, the loads read on
    the host (its plain form)."""
    T, D = x.shape
    E, k = params["w_in"].shape[0], ids.shape[1]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = x[order // k]  # [T k, D], by expert
    loads = expert_loads(ids, E)
    if x.dtype == torch.bfloat16:
        offs = torch.cumsum(loads, dim=0).to(torch.int32)
        gate, up = torch._grouped_mm(rows, params["w_in"].transpose(1, 2),
                                     offs=offs).chunk(2, dim=-1)
        y = torch._grouped_mm(_silu_glu(gate, up), params["w_out"].transpose(1, 2),
                              offs=offs)
        del gate, up
    else:
        y = torch.empty_like(rows)
        start = 0
        for e, n in enumerate(loads.tolist()):
            if n:
                r = rows[start: start + n]
                gate, up = (r @ params["w_in"][e].t()).chunk(2, dim=-1)
                y[start: start + n] = _silu_glu(gate, up) @ params["w_out"][e].t()
                start += n
    del rows
    y.mul_(probs.reshape(-1)[order].to(x.dtype)[:, None])
    out = torch.empty_like(y)
    out[order] = y
    return out.reshape(T, k, D).sum(dim=1)


def moe_dropless(x: torch.Tensor, params: dict, top_k: int,
                 static: bool = False) -> tuple[torch.Tensor, torch.Tensor, Optional[list]]:
    """The dropless MoE over x [T, D] with ``params`` {'router' [D, E],
    'w_in' [E, 2 F, D], 'w_out' [E, D, F]}: (y [T, D] in x's dtype, the
    routed ids [T, k], the experts' loads as a host list or None).

    Routing is ``route``'s (top k of the f32 logits, a softmax over the k);
    the gates are cast to x's dtype and multiply each expert's output, as
    ``GraniteMoeHybridTopKGating`` does (``experts_in_slots``).  ``static``
    False gives each expert as many slots as the largest load, read on the
    host (a prefill: one wait, no loop over the experts); ``static`` True
    gives it T, which no expert overflows since a token picks an expert
    once, so every shape is fixed (a decode step that a CUDA graph
    captures; loads None)."""
    E = params["w_in"].shape[0]
    probs, ids, _ = route(x, params["router"], top_k)
    loads = None if static else expert_loads(ids, E).tolist()
    cap = x.shape[0] if static else max(loads)
    return experts_in_slots(x, params, probs, ids, cap), ids, loads


def moe_reference(x: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """Dense all-experts oracle: O(E) compute, exact dropless semantics."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, ids, _ = router_topk(xt, params["router"], cfg.top_k)
    g = torch.einsum("td,edf->tef", xt, params["w_gate"])
    u = torch.einsum("td,edf->tef", xt, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", _silu_glu(g, u), params["w_down"])
    w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=probs.dtype, device=x.device)
    w.scatter_(1, ids, probs)  # a token's k ids are distinct
    y = torch.einsum("ted,te->td", y_all, w.to(y_all.dtype))
    return y.reshape(B, S, D).to(x.dtype)
