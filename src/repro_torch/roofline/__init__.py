# Execution policy of the padded fused scans (see costmodel.py).
from repro_torch.roofline import costmodel  # noqa: F401
