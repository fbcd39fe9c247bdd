"""TCL flow-script generation (paper: "a library of finely-tailored TCL
scripts and templates for automating the various design flows and PDKs").

Templates target Cadence Genus (synthesis) and Innovus (place-and-route),
parameterized per design and per library, exactly as TNNGen emits them; they
are written to the design's build directory by ``flow.py``.  The scripts are
real and runnable on a Cadence install; in this environment they serve as
the flow's declarative record (and are what the tests golden-check).

The port's own copy of the JAX package's ``hwgen/tcl.py``: the scripts it
writes are the JAX package's byte for byte except the banner line, which
names ``repro_torch.hwgen``.
"""
from __future__ import annotations

from repro_torch.hwgen.rtl import ColumnSpec

_LIB_FILES = {
    "freepdk45": "freepdk45/lib/NangateOpenCellLibrary_typical.lib",
    "asap7": "asap7/lib/asap7sc7p5t_RVT_TT_nldm.lib",
    "tnn7": "tnn7/lib/tnn7_macros_TT_nldm.lib",  # ASAP7 + TNN custom macros
}

_LEF_FILES = {
    "freepdk45": "freepdk45/lef/NangateOpenCellLibrary.macro.lef",
    "asap7": "asap7/lef/asap7sc7p5t.lef",
    "tnn7": "tnn7/lef/tnn7_macros.lef",
}

# TNN7 custom macros mapped during synthesis (Nair et al. ISVLSI'22): the
# 8-1 WTA macro, the RNL response macro, and the STDP update macro.
_TNN7_MACRO_MAP = """\
# map TNN building blocks onto TNN7 custom macros
set_db [vfind /des* -hinst *u_rnl*]  .preserve map
set_db [vfind /des* -hinst *u_stdp*] .preserve map
set_db [vfind /des* -hinst *u_wta*]  .preserve map
read_physical -lef $TNN7_MACRO_LEF
"""


def genus_script(spec: ColumnSpec, library: str, clock_ns: float = 1.0) -> str:
    top = f"tnn_column_{spec.name}"
    macro = _TNN7_MACRO_MAP if library == "tnn7" else "# (no custom macros)"
    return f"""\
# Genus synthesis script — generated by repro_torch.hwgen for {top} / {library}
set_db init_lib_search_path $env(PDK_ROOT)
read_libs {_LIB_FILES[library]}
read_hdl {{rnl_unit.v neuron.v wta_inhibit.v stdp_unit.v {top}.v}}
elaborate {top}
create_clock -name clk -period {clock_ns} [get_ports clk]
set_db syn_generic_effort high
set_db syn_map_effort high
set_db syn_opt_effort high
{macro}
syn_generic
syn_map
syn_opt
report_area    > reports/{top}_{library}_area.rpt
report_power   > reports/{top}_{library}_power.rpt
report_timing  > reports/{top}_{library}_timing.rpt
write_hdl      > out/{top}_{library}_netlist.v
write_sdc      > out/{top}_{library}.sdc
"""


def innovus_script(spec: ColumnSpec, library: str, utilization: float = 0.7) -> str:
    top = f"tnn_column_{spec.name}"
    return f"""\
# Innovus place-and-route script — generated by repro_torch.hwgen for {top} / {library}
set init_verilog out/{top}_{library}_netlist.v
set init_lef_file {_LEF_FILES[library]}
set init_top_cell {top}
init_design
floorPlan -su 1.0 {utilization} 2.0 2.0 2.0 2.0
place_opt_design
ccopt_design
routeDesign
optDesign -postRoute
report_area          > reports/{top}_{library}_pnr_area.rpt
report_power -leakage > reports/{top}_{library}_pnr_power.rpt
summaryReport -outfile reports/{top}_{library}_pnr_summary.rpt
saveNetlist out/{top}_{library}_routed.v
# NOTE (paper §II-B): DRC/LVS signoff is intentionally out of scope.
"""


def xcelium_script(spec: ColumnSpec) -> str:
    top = f"tnn_column_{spec.name}"
    return f"""\
# Xcelium RTL-simulation script — generated by repro_torch.hwgen
xrun -64bit -access +rwc rnl_unit.v neuron.v wta_inhibit.v stdp_unit.v \\
    {top}.v tb_{spec.name}.v -top tb_{spec.name} -input dump.tcl
"""


def generate_flow_scripts(spec: ColumnSpec, library: str) -> dict:
    return {
        f"synth_{library}.tcl": genus_script(spec, library),
        f"pnr_{library}.tcl": innovus_script(spec, library),
        "rtl_sim.sh": xcelium_script(spec),
    }
