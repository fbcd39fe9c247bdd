"""Design-space exploration (DSE) for NSPU column designs.

Closes the TNNGen loop from functional simulation to *forecasted*
silicon: ``explore`` sweeps a ``DesignSpace`` over a labeled stream via
the envelope-bucketed design sweep
(``simulator.cluster_time_series_many``, on the card unless the caller
passes ``device='cpu'``), pairs every design's Rand index with
forecasted area/leakage (``repro_torch.hwgen.forecast``), and returns the
Pareto frontier of quality vs silicon cost.

Long runs are fault-tolerant by default: failing candidates are
quarantined as ``EvalFailure`` records instead of aborting the sweep,
and ``explore(journal=..., resume=True)`` makes completed evaluations
durable across kills via an atomically-published ``Journal``.  The
port's counterpart of the JAX package's ``dse`` package.
"""
from repro_torch.core.simulator import EvalFailure
from repro_torch.dse.explore import DSEResult, explore, initial_weights, summarize
from repro_torch.dse.journal import Journal, candidate_fingerprint
from repro_torch.dse.pareto import DesignPoint, dominates, pareto_front
from repro_torch.dse.space import (
    Candidate,
    DesignSpace,
    candidate_config,
)

__all__ = [
    "Candidate",
    "DSEResult",
    "DesignPoint",
    "DesignSpace",
    "EvalFailure",
    "Journal",
    "candidate_config",
    "candidate_fingerprint",
    "dominates",
    "explore",
    "initial_weights",
    "pareto_front",
    "summarize",
]
