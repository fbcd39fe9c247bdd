# The TNNGen functional simulator in PyTorch: temporal (spike-time) neural
# networks with RNL/SNL/LIF response functions, WTA inhibition, online STDP
# and hybrid event-driven / cycle-accurate timing.
from repro_torch.core.types import (  # noqa: F401
    ColumnConfig,
    LayerConfig,
    NetworkConfig,
    NeuronConfig,
    STDPConfig,
    TIME_DTYPE,
    WEIGHT_DTYPE,
    WTAConfig,
    no_spike,
)
from repro_torch.core import column, encoding, neuron, simulator, stdp, wta  # noqa: F401
