"""The paper's own seven TNN column designs (Table II) as configs."""
from __future__ import annotations

from repro_torch.core.types import ColumnConfig, NeuronConfig
from repro_torch.data.ucr import PAPER_COLUMNS

T_MAX = 64  # gamma window used by the simulator configs


def column_config(benchmark: str, t_max: int = T_MAX) -> ColumnConfig:
    p, q = PAPER_COLUMNS[benchmark]
    # threshold at the simulator's default operating point (see
    # core/simulator.suggest_threshold): p * w_max / 8
    thr = max(1.0, 0.25 * p * 7 / 2.0)
    return ColumnConfig(p=p, q=q, t_max=t_max, neuron=NeuronConfig(threshold=thr))


def all_benchmarks() -> list:
    return list(PAPER_COLUMNS)
