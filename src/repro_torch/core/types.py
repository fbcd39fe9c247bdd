"""Core datatypes for temporal (spike-time) computation.

Spike times are integer clock cycles in ``[0, t_max)``; the sentinel
``NO_SPIKE`` (== t_inf, a value >= t_max) encodes "never spiked", matching the
unary-temporal hardware encoding in Nair et al. (ISVLSI'21) where absence of a
spike is an all-zeros unary wavefront.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Integer dtype used for spike times throughout (the JAX package's choice,
# so arrays cross between the packages unchanged); hardware uses
# log2(t_max)-bit counters.
TIME_DTYPE = torch.int32
WEIGHT_DTYPE = torch.float32


def no_spike(t_max: int) -> int:
    """Sentinel spike time representing 'no spike' (one past the window)."""
    return int(t_max)


@dataclasses.dataclass(frozen=True)
class NeuronConfig:
    """Response-function configuration for one neuron population.

    Attributes:
      response: 'rnl' (ramp-no-leak), 'snl' (step-no-leak) or 'lif'.
      threshold: body-potential firing threshold (integer-valued in hardware).
      w_max: maximum synaptic weight (3-bit weights -> 7, as in TNN7 macros).
      leak: LIF leak per cycle (ignored for rnl/snl).
      refractory: cycles after firing during which the neuron is silent.
    """

    response: str = "rnl"
    threshold: float = 32.0
    w_max: int = 7
    leak: float = 0.0
    refractory: int = 0

    def __post_init__(self):
        if self.response not in ("rnl", "snl", "lif"):
            raise ValueError(f"unknown response function: {self.response!r}")
        if self.w_max < 1:
            raise ValueError("w_max must be >= 1")


@dataclasses.dataclass(frozen=True)
class WTAConfig:
    """Winner-take-all lateral inhibition.

    Attributes:
      k: number of winners that keep their spikes (1 = classic 1-WTA).
      tie_break: 'index' (lowest neuron index wins, hardware priority
        encoder), 'random' (PRNG tie-break), or 'all' (ties all win).
    """

    k: int = 1
    tie_break: str = "index"

    def __post_init__(self):
        if self.tie_break not in ("index", "random", "all"):
            raise ValueError(f"unknown tie_break: {self.tie_break!r}")


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    """Probabilistic TNN STDP (Smith 2020; Chaudhari et al. 2021).

    Update cases for an input spike at x and (post-WTA) output spike at y:
      capture : x and y spike, x <= y  -> w += mu_capture * B(w)
      backoff : x and y spike, x >  y  -> w -= mu_backoff * B(w)
      search  : x spikes, y does not   -> w += mu_search
      backoff2: y spikes, x does not   -> w -= mu_backoff * B(w)
    B(w) is the stabilizing function; 'half' uses the standard
    B(w) = ceil-expectation form that slows updates near the rails.
    """

    mu_capture: float = 1.0 / 2
    mu_backoff: float = 1.0 / 2
    mu_search: float = 1.0 / 1024
    stabilizer: str = "half"  # 'half' or 'none'
    mode: str = "expected"  # 'expected' (deterministic) or 'stochastic'

    def __post_init__(self):
        if self.stabilizer not in ("half", "none"):
            raise ValueError(f"unknown stabilizer: {self.stabilizer!r}")
        if self.mode not in ("expected", "stochastic"):
            raise ValueError(f"unknown mode: {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """A single-column TNN: p synapses (rows) x q neurons (columns).

    This is the paper's NSPU building block; Table II uses (p x q) in
    {65x2, 96x2, 152x2, 343x2, 637x2, 470x5, 270x25}.
    """

    p: int
    q: int
    t_max: int = 256  # temporal window in clock cycles (8-bit time)
    neuron: NeuronConfig = dataclasses.field(default_factory=NeuronConfig)
    wta: WTAConfig = dataclasses.field(default_factory=WTAConfig)
    stdp: STDPConfig = dataclasses.field(default_factory=STDPConfig)

    @property
    def synapse_count(self) -> int:
        return self.p * self.q

    def with_threshold(self, threshold: float) -> "ColumnConfig":
        return dataclasses.replace(
            self, neuron=dataclasses.replace(self.neuron, threshold=threshold)
        )


def column_config_from_dict(d: dict) -> ColumnConfig:
    """Inverse of ``dataclasses.asdict(ColumnConfig(...))`` — the config
    serialization used by the DSE journal and the serving durability
    metadata, whose recovery paths must reconstruct the exact config
    (every field is an int/float/str, so the JSON round trip is exact)."""
    return ColumnConfig(
        p=int(d["p"]),
        q=int(d["q"]),
        t_max=int(d["t_max"]),
        neuron=NeuronConfig(**d["neuron"]),
        wta=WTAConfig(**d["wta"]),
        stdp=STDPConfig(**d["stdp"]),
    )


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """One layer of a multi-layer TNN: a grid of columns.

    Attributes:
      columns: number of parallel columns in the layer.
      column: per-column config (shared).
      connectivity: 'full' (every column sees all inputs) or 'tiled'
        (column c sees the c-th contiguous slice of the input).
    """

    columns: int
    column: ColumnConfig
    connectivity: str = "full"

    def __post_init__(self):
        if self.connectivity not in ("full", "tiled"):
            raise ValueError(f"unknown connectivity: {self.connectivity!r}")


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Multi-layer TNN (paper §II-A: arbitrary layers/columns)."""

    layers: tuple  # tuple[LayerConfig, ...]
    name: str = "tnn"
