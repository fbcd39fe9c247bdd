"""Shared test instrumentation of the port.

``repro_torch.testing.faults`` is the deterministic fault-injection
harness at the ``fused_column`` seam, behind the serving fault tests and
the card's serving checks.
"""
from repro_torch.testing import faults

__all__ = ["faults"]
