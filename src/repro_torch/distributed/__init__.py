# Distributed runtime of the port: optimizers (AdamW, factored Adafactor,
# int8 error-feedback compression), the trainer with microbatches and
# checkpoint restart, elastic resume, straggler monitoring, and the
# checkpointer (also the streaming service's live-weight snapshots).
from repro_torch.distributed import (  # noqa: F401
    checkpoint,
    elastic,
    optimizer,
    straggler,
    train_loop,
)
from repro_torch.distributed.checkpoint import Checkpointer  # noqa: F401
