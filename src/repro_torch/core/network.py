"""Multi-layer TNNs: grids of columns with configurable connectivity.

Paper §II-A: "large multi-layer TNNs with an arbitrary number of layers and
columns per layer with configurable inter-layer connectivity".  Layer l
holds ``columns`` parallel columns; their post-WTA spike volleys
concatenate into the next layer's input volley.  Training is greedy
layer-wise unsupervised STDP: each layer trains on the frozen output of
the stack below it.

``mode`` ('auto' | 'event' | 'cycle' | 'pallas') resolves per layer
through ``backend.resolve``, as for single columns:

* layers that resolve to 'pallas' train through
  ``fused_column.fit_scan_padded``, the layer's columns as the design
  axis of one padded scan (the volley-block kernel on the card).  Fused
  layers that could share a padded scan (same column count and static
  hyper-parameters, sizes within ``backend.ENVELOPE_WASTE_CAP``) are
  padded into one (p, q, t_max) envelope, as the JAX package does to
  share a compiled step;
* layers that resolve to 'event' / 'cycle' (LIF, stochastic STDP, random
  tie-break, ...) run ``backend.solver_volley_step`` over epochs x
  volleys x columns.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import column as column_lib
from repro_torch.core.types import (
    ColumnConfig,
    LayerConfig,
    NetworkConfig,
    TIME_DTYPE,
    WEIGHT_DTYPE,
)
from repro_torch.kernels import fused_column


def _layer_input_width(layer: LayerConfig, in_width: int) -> int:
    if layer.connectivity == "full":
        return in_width
    if in_width % layer.columns != 0:
        raise ValueError(
            f"tiled connectivity needs in_width % columns == 0, got "
            f"{in_width} % {layer.columns}"
        )
    return in_width // layer.columns


def validate(cfg: NetworkConfig, in_width: int) -> None:
    """Check that declared column widths match the connectivity plan, and
    that temporal windows never grow across layers (a layer's no-spike
    sentinel is its t_max, so a later layer with a larger window would
    read upstream silence as a live late spike)."""
    width = in_width
    for li, layer in enumerate(cfg.layers):
        need = _layer_input_width(layer, width)
        if layer.column.p != need:
            raise ValueError(
                f"layer {li}: column.p={layer.column.p} but connectivity "
                f"provides {need} inputs"
            )
        if li > 0 and layer.column.t_max > cfg.layers[li - 1].column.t_max:
            raise ValueError(
                f"layer {li}: t_max={layer.column.t_max} exceeds layer "
                f"{li - 1}'s t_max={cfg.layers[li - 1].column.t_max}; the "
                "upstream no-spike sentinel would alias into a live spike"
            )
        width = layer.columns * layer.column.q


def in_width(cfg: NetworkConfig) -> int:
    """Input volley width layer 0's connectivity plan expects."""
    layer0 = cfg.layers[0]
    if layer0.connectivity == "full":
        return layer0.column.p
    return layer0.columns * layer0.column.p


def out_width(cfg: NetworkConfig) -> int:
    """Width of the final layer's concatenated post-WTA volley."""
    last = cfg.layers[-1]
    return last.columns * last.column.q


def init_params(
    cfg: NetworkConfig,
    in_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    params: Optional[list] = None,
) -> list:
    """Per-layer params: a list of {'w': [columns, p, q]}.

    Weights are uniform over [0, w_max], drawn on the CPU from
    ``generator`` layer by layer and column by column, then moved to
    ``device``.  Explicit ``params`` are taken as they are instead
    (checked against the config).
    """
    validate(cfg, in_width)
    device = backend_lib.default_device(device)
    out = []
    for li, layer in enumerate(cfg.layers):
        shape = (layer.columns, layer.column.p, layer.column.q)
        if params is None:
            w = torch.rand(shape, generator=generator, dtype=WEIGHT_DTYPE)
            w = w * float(layer.column.neuron.w_max)
        else:
            w = torch.as_tensor(params[li]["w"], dtype=WEIGHT_DTYPE)
            if tuple(w.shape) != shape:
                raise ValueError(
                    f"layer {li}: w must be {shape}, got {tuple(w.shape)}"
                )
        out.append({"w": w.to(device).contiguous()})
    return out


def params_from_jax(params: list, device=None) -> list:
    """Carry the JAX package's network weights across: a list of
    {'w': array} (numpy, or anything ``np.asarray`` takes) -> a list of
    {'w': f32 tensor}."""
    device = backend_lib.default_device(device)
    return [
        {"w": torch.from_numpy(np.array(lp["w"], np.float32)).to(device)}
        for lp in params
    ]


def _split_columns(x: torch.Tensor, layer: LayerConfig) -> torch.Tensor:
    """Distribute a volley over a layer's columns: [..., in_w] -> [..., c, p]."""
    c = layer.columns
    if layer.connectivity == "full":
        return x[..., None, :].expand(x.shape[:-1] + (c, x.shape[-1]))
    return x.reshape(x.shape[:-1] + (c, layer.column.p))


def _apply_layer(
    lp: dict, x: torch.Tensor, layer: LayerConfig, mode: str
) -> torch.Tensor:
    """x: [..., in_width] -> [..., columns * q] post-WTA spike times."""
    xc = _split_columns(x, layer)
    ys = [
        column_lib.apply({"w": lp["w"][c]}, xc[..., c, :], layer.column, mode)[0]
        for c in range(layer.columns)
    ]
    return torch.cat(ys, dim=-1)


def apply(
    params: list, x_times: torch.Tensor, cfg: NetworkConfig, mode: str = "auto"
) -> torch.Tensor:
    """Forward a volley through all layers; returns the final spike volley.
    ``mode`` resolves per layer (inside ``column.apply``)."""
    validate(cfg, x_times.shape[-1])
    h = x_times
    for lp, layer in zip(params, cfg.layers):
        h = _apply_layer(lp, h, layer, mode)
    return h


def cluster_assignments(
    params: list, x_times: torch.Tensor, cfg: NetworkConfig, mode: str = "auto"
) -> torch.Tensor:
    """Winner index in the final concatenated volley = cluster id;
    ``out_width(cfg)`` when no output neuron spikes."""
    y = apply(params, x_times, cfg, mode)
    t_max = cfg.layers[-1].column.t_max
    any_spike = (y < t_max).any(dim=-1)
    idx = torch.argmin(y, dim=-1)
    return torch.where(any_spike, idx, out_width(cfg)).to(TIME_DTYPE)


# ------------------------------------------------------------ layer training
def _fused_group_key(layer: LayerConfig):
    """Layers may share one padded envelope iff they have the same column
    count and static hyper-parameters."""
    c = layer.column
    return (layer.columns, c.neuron.w_max, c.neuron.response, c.wta.k, c.stdp)


def _fused_envelopes(layers: list[LayerConfig]) -> list[tuple[int, int, int]]:
    """Per-layer (p, q, t_window) padding envelope, in input order:
    layers group by ``_fused_group_key``, and within a group pack into
    envelopes by ``backend.envelope_buckets``.  No result depends on the
    envelope."""
    by_key: dict[tuple, list[int]] = {}
    for i, l in enumerate(layers):
        by_key.setdefault(_fused_group_key(l), []).append(i)
    envs: list = [None] * len(layers)
    for idxs in by_key.values():
        shapes = [
            (layers[i].column.p, layers[i].column.q, layers[i].column.t_max)
            for i in idxs
        ]
        for env, members in backend_lib.envelope_buckets(shapes):
            for m in members:
                envs[idxs[m]] = env
    return envs


def _fit_layer_fused(
    w: torch.Tensor,
    hc: torch.Tensor,
    cfg: ColumnConfig,
    envelope: tuple[int, int, int],
    epochs: int,
    plan_sink: Optional[list] = None,
) -> torch.Tensor:
    """Train one layer's columns on the fused path: [c, p, q], [N, c, p]
    -> [c, p, q].  Pads weights and volleys into the envelope (pad
    synapses silent at t_window) and drives
    ``fused_column.fit_scan_padded`` with the columns as the design axis
    and the ``v_blk`` of the layer's plan."""
    lowering = backend_lib.padded_lowering(cfg.neuron.response, w)
    fused_column.check_fusable(cfg, lowering)
    c = w.shape[0]
    p_env, q_env, t_window = envelope
    w_pad = torch.zeros((c, p_env, q_env), dtype=torch.float32, device=w.device)
    w_pad[:, : cfg.p, : cfg.q] = w
    xs = torch.full(hc.shape[:-1] + (p_env,), t_window, dtype=TIME_DTYPE,
                    device=w.device)
    xs[..., : cfg.p] = hc
    plan = backend_lib.execution_plan("fit", lowering, c, hc.shape[0])
    w_new = fused_column.fit_scan_padded(
        w_pad, xs, [cfg.neuron.threshold] * c, [cfg.t_max] * c, [cfg.q] * c,
        t_window=t_window, w_max=cfg.neuron.w_max, wta_k=cfg.wta.k,
        mu_capture=cfg.stdp.mu_capture, mu_backoff=cfg.stdp.mu_backoff,
        mu_search=cfg.stdp.mu_search,
        stabilize=cfg.stdp.stabilizer == "half",
        response=cfg.neuron.response, epochs=epochs, lowering=lowering,
        v_blk=plan.v_blk,
    )
    if plan_sink is not None:
        plan_sink.append(plan.meta())
    return w_new[:, : cfg.p, : cfg.q]


def _layer_solver_fit_scan(
    w: torch.Tensor,
    xs: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: ColumnConfig,
    solver_mode: str,
    epochs: int,
) -> torch.Tensor:
    """One layer's epochs x volleys on the event/cycle solvers: each
    volley steps every column (``backend.solver_volley_step``).
    ``w``: [c, p, q] (not modified), ``xs``: [N, c, p]."""
    cols = [w[c].to(torch.float32).clone() for c in range(w.shape[0])]
    for _ in range(epochs):
        for xt in xs:
            for c in range(len(cols)):
                cols[c], _ = backend_lib.solver_volley_step(
                    cols[c], xt[c], generator, cfg, solver_mode
                )
    return torch.stack(cols)


def fit_greedy(
    params: list,
    x_times: torch.Tensor,
    cfg: NetworkConfig,
    epochs: int = 8,
    mode: str = "auto",
    generator: Optional[torch.Generator] = None,
    plan_sink: Optional[list] = None,
) -> list:
    """Greedy layer-wise unsupervised STDP training.

    Each layer trains on the frozen output of the stack below it, then is
    frozen in turn.  ``mode`` resolves per layer (``backend.resolve``):
    fused layers train as one padded scan, the rest on the solvers.
    ``generator`` is required whenever a layer is stochastic (random
    tie-break or stochastic STDP).  ``plan_sink``, a list, receives each
    fused layer's ``ExecutionPlan.meta()`` in layer order.
    """
    if generator is None:
        for li, layer in enumerate(cfg.layers):
            if layer.column.wta.tie_break == "random":
                raise ValueError(
                    f"layer {li}: tie_break='random' requires a torch.Generator"
                )
            if layer.column.stdp.mode == "stochastic":
                raise ValueError(
                    f"layer {li}: stochastic STDP requires a torch.Generator"
                )
    validate(cfg, x_times.shape[-1])
    h = x_times.reshape((-1, x_times.shape[-1]))

    names = [
        backend_lib.resolve(mode, layer.column, training=True)
        for layer in cfg.layers
    ]
    fused_idx = [i for i, nm in enumerate(names) if nm == "pallas"]
    env_by_layer = dict(zip(
        fused_idx,
        _fused_envelopes([cfg.layers[i] for i in fused_idx]),
    ))

    new_params = []
    for li, (lp, layer, name) in enumerate(zip(params, cfg.layers, names)):
        hc = _split_columns(h, layer)  # [N, c, p]
        if name == "pallas":
            w = _fit_layer_fused(
                lp["w"], hc, layer.column, env_by_layer[li], epochs,
                plan_sink=plan_sink,
            )
        else:
            w = _layer_solver_fit_scan(
                lp["w"], hc, generator, layer.column, name, epochs
            )
        new_params.append({"w": w})
        if li < len(cfg.layers) - 1:  # the last handoff has no consumer
            h = _apply_layer({"w": w}, h, layer, mode)
    return new_params
