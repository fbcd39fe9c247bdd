# Distributed runtime of the port: straggler monitoring (StepMonitor, used
# by the design-space exploration and the streaming service) and the
# checkpointer (the service's live-weight snapshots).
from repro_torch.distributed import checkpoint, straggler  # noqa: F401
from repro_torch.distributed.checkpoint import Checkpointer  # noqa: F401
