"""Three-term roofline analysis over the dry run's cells.

Port of the JAX package's ``roofline/analysis.py``, with the same terms
and formulas.  The peaks come from a ``costmodel.DeviceProfile``: the
explicit profile, else the active one (``costmodel.override``), else
the port's ``PROFILES['h100-sxm']``.  That profile's ``peak_flops`` is
the f32 rate outside the tensor cores, so the compute term of a bf16
cell is pessimistic unless the caller passes a profile whose peak is a
measured bf16 rate.  A profile
with no link bandwidth (``link_bw`` 0: every one-card profile) gives a
NaN collective term, ``dominant`` is taken over compute and memory, and
``note`` says so; no interconnect figure is assumed.

Terms, in seconds per step, all PER DEVICE (the dry run counts one
device's local ops and wire bytes):

    compute_s    = FLOPs / PEAK_FLOPS
    memory_s     = bytes accessed / HBM_BW
    collective_s = collective_bytes / LINK_BW

MODEL_FLOPS = 6 * N(_active) * tokens for training (2N fwd + 4N bwd)
and 2 * N(_active) * tokens for inference; ``useful_ratio`` = MODEL_FLOPS
/ FLOPs_global catches remat/redundancy waste.  ``roofline_fraction`` =
useful compute time / dominant term: the MFU the step would reach if it
ran exactly at the binding roofline.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
from typing import Optional

from repro_torch.roofline import costmodel

_DEFAULT_PROFILE = costmodel.PROFILES["h100-sxm"]

RESULTS_DIR = "results/dryrun"

NO_LINK_NOTE = "no link bandwidth in the profile: collective term not computed"


def peaks(
    prof: Optional[costmodel.DeviceProfile] = None,
) -> tuple[float, float, float, str]:
    """``(peak_flops, hbm_bw, link_bw, profile_name)`` for the analysis.

    Resolution order: explicit ``prof`` argument, then the active
    profile (``costmodel.profile()``), then ``'h100-sxm'``.  A profile
    without a link bandwidth gives ``link_bw`` 0.
    """
    p = prof if prof is not None else costmodel.profile()
    if p is None:
        p = _DEFAULT_PROFILE
    link = p.link_bw if p.link_bw and p.link_bw > 0 else 0.0
    return p.peak_flops, p.hbm_bw, link, p.name


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    n_chips: int = 0
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_min_s: float = 0.0  # fused lower bound (see analyze_cell)
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    fraction_fused: float = 0.0
    peak_mem_gb: float = 0.0
    note: str = ""
    # which DeviceProfile supplied the peaks
    profile: str = ""

    @property
    def bound_s(self) -> float:
        return _max_terms(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound_fused_s(self) -> float:
        return _max_terms(self.compute_s, self.memory_min_s, self.collective_s)


def _max_terms(*terms: float) -> float:
    return max(t for t in terms if not math.isnan(t))


def load_cells(results_dir: str = RESULTS_DIR) -> list:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def analyze_cell(cell: dict,
                 prof: Optional[costmodel.DeviceProfile] = None) -> RooflineRow:
    if cell.get("status") != "ok":
        return RooflineRow(
            arch=cell["arch"], shape=cell["shape"], mesh=cell.get("mesh", "?"),
            status=cell.get("status", "?"), note=cell.get("reason", ""),
        )
    ex = cell.get("extrapolated") or {}
    cost = cell.get("cost_analysis") or {}
    flops = ex.get("flops", cost.get("flops", 0.0))
    byts = ex.get("bytes accessed", cost.get("bytes accessed", 0.0))
    coll = (ex.get("collective_bytes") or cell.get("collective_bytes", {})).get(
        "total", 0.0
    )
    n = cell["n_chips"]
    peak_flops, hbm_bw, link_bw, prof_name = peaks(prof)
    compute_s = flops / peak_flops
    memory_s = byts / hbm_bw
    collective_s = coll / link_bw if link_bw else math.nan
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    known = {k: v for k, v in terms.items() if not math.isnan(v)}
    dominant = max(known, key=known.get)
    note = "" if link_bw else NO_LINK_NOTE
    # MODEL_FLOPS (standard convention): training = 6*N_active per token
    # (2N fwd + 4N bwd); inference (prefill/decode) = 2*N_active per token.
    from repro_torch.configs import SHAPES

    sh = SHAPES[cell["shape"]]
    n_active = cell.get("active_params", 0)
    if sh.kind == "train":
        model_flops = 6.0 * n_active * sh.global_batch * sh.seq_len
    elif sh.kind == "prefill":
        model_flops = 2.0 * n_active * sh.global_batch * sh.seq_len
    else:
        model_flops = 2.0 * n_active * sh.global_batch
    hlo_global = flops * n
    useful = model_flops / hlo_global if hlo_global else 0.0
    useful_time = model_flops / (n * peak_flops)
    bound = max(known.values())
    frac = useful_time / bound if bound else 0.0
    mem = cell.get("memory_analysis", {})
    peak = (
        mem.get("argument_size_in_bytes", 0)
        + mem.get("temp_size_in_bytes", 0)
        + mem.get("output_size_in_bytes", 0)
        - mem.get("alias_size_in_bytes", 0)
    )
    # Fused lower bound on HBM traffic: the per-op 'bytes accessed' counts
    # every op unfused.  Minimum = read every argument + write every
    # output once + layer-boundary activation traffic (saved fwd / read
    # bwd / written grads for train; streamed once for serve).
    from repro_torch.configs import get_arch

    try:
        cfg = get_arch(cell["arch"])
        dp = n // 16  # model axis is 16 on both meshes
        tokens_local = sh.global_batch * (
            sh.seq_len if sh.kind != "decode" else 1
        ) / max(dp, 1)
        bound_factor = 3.0 if sh.kind == "train" else 1.0
        boundary = bound_factor * cfg.n_layers * tokens_local * cfg.d_model * 2
    except Exception:
        boundary = 0.0
    min_bytes = (
        mem.get("argument_size_in_bytes", 0)
        + mem.get("output_size_in_bytes", 0)
        + boundary
    )
    memory_min_s = min_bytes / hbm_bw
    bound_fused = _max_terms(compute_s, memory_min_s, collective_s)
    frac_fused = useful_time / bound_fused if bound_fused else 0.0
    return RooflineRow(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"], status="ok",
        n_chips=n, compute_s=compute_s, memory_s=memory_s,
        memory_min_s=memory_min_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=model_flops, hlo_flops_global=hlo_global,
        useful_ratio=useful, roofline_fraction=frac,
        fraction_fused=frac_fused,
        peak_mem_gb=peak / 1e9,
        note=note,
        profile=prof_name,
    )


def analyze_all(results_dir: str = RESULTS_DIR, mesh: Optional[str] = "single",
                prof: Optional[costmodel.DeviceProfile] = None) -> list:
    rows = [analyze_cell(c, prof) for c in load_cells(results_dir)]
    if mesh:
        rows = [r for r in rows if r.mesh == mesh or r.status != "ok"]
    return rows


def render_markdown(rows: list) -> str:
    hdr = (
        "| arch | shape | chips | compute_s | memory_s (hlo/min) | "
        "collective_s | dominant | MODEL/HLO | frac (hlo/fused) | "
        "peak GB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        if r.status == "skipped":
            lines.append(
                f"| {r.arch} | {r.shape} | — | — | — | — | skipped | — | — | — |"
            )
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | {r.n_chips} | {r.compute_s:.4f} | "
            f"{r.memory_s:.3f} / {r.memory_min_s:.3f} | {r.collective_s:.4f} | "
            f"**{r.dominant}** | {r.useful_ratio:.3f} | "
            f"{r.roofline_fraction:.3f} / {r.fraction_fused:.3f} | "
            f"{r.peak_mem_gb:.1f} |"
        )
    return hdr + "\n".join(lines) + "\n"


def pick_hillclimb_cells(rows: list) -> dict:
    """The three §Perf cells: worst roofline fraction, most collective-bound,
    most representative of the paper's technique (for the LM pillar the
    largest-scale MoE cell)."""
    ok = [r for r in rows if r.status == "ok"]
    worst = min(ok, key=lambda r: r.roofline_fraction)
    coll = max(ok, key=lambda r: (0.0 if math.isnan(r.collective_s)
                                  else r.collective_s / max(r.bound_s, 1e-12)))
    moe = [r for r in ok if r.arch.startswith("kimi")] or ok
    rep = max(moe, key=lambda r: r.model_flops)
    return {"worst_fraction": worst, "most_collective_bound": coll,
            "paper_representative": rep}
