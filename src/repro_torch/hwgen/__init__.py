# TNNGen hardware generator (paper §II-B): PyTorch-model-spec -> Verilog RTL
# -> TCL flow scripts -> (simulated) synthesis/P&R -> post-layout metrics,
# plus the paper's forecasting feature.  See DESIGN.md §2 for what is real
# (RTL/TCL generation, forecasting) vs modeled (Cadence execution).
# The port's own copy of the JAX package's hardware generator: numpy,
# hashlib and json only; the same RTL and scripts (but for the banner
# naming the generator), flow results and forecasts.
from repro_torch.hwgen import flow, forecast, pdk, rtl, tcl  # noqa: F401
from repro_torch.hwgen.flow import FlowResult, ModelExecutor, run_flow  # noqa: F401
from repro_torch.hwgen.rtl import ColumnSpec  # noqa: F401
