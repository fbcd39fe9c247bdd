# Distributed runtime of the port.  So far only straggler monitoring
# (StepMonitor), which the design-space exploration uses.
from repro_torch.distributed import straggler  # noqa: F401
