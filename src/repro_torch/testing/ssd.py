"""Inputs for the SSD scan and the bound its kernel is held to against the
plain version (``models.ssm.ssd_chunked_plain``): shared by the card
tests and ``chip_smoke.py``.

The kernel makes the plain version's roundings and sums in another order,
so the bound is per element, in units of the sum of the magnitudes of the
terms that make the element (the plain scan of |x|, |B|, |C| and
|state|, all of whose terms are then positive):
* ``SUM_ORDER`` of it for f32 sums in another order: the plain scan's
  longest sums are the 256 terms of a chunk, plus the state's carry over
  the chunks; n u with n ~ 300 and u = 2^-24 is ~2^-15.7, taken as 2^-14;
* in bf16, ``BF16_FLIP`` of the intra-chunk terms alone (a chunk's scan
  from a zero state): a score C_i . B_j summed in another order can round
  to the other side of a bf16 boundary, one bf16 ulp, 2^-7 of the value
  at most, and so can a mask entry where the exponent differs in its last
  bit; both at once, 2^-6;
* an absolute 1e-30, for terms at the bottom of f32's range (bf16 parts
  of a value end at bf16's smallest subnormal, 2^-133).
In the norm, the difference is held to ``NORM`` of the intra-chunk terms
(bf16 only) plus ``SUM_ORDER`` of all terms: the flips are rare (a score
sits within the sum order's error of a bf16 boundary for ~2^-13 of the
entries), so their norm stays far below the per-element bound, while one
bf16 rounding of mask * scores where the plain version keeps the product
exact (up to 2^-9 of every intra-chunk term) reads above it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import ssm

SUM_ORDER = 2.0 ** -14
BF16_FLIP = 2.0 ** -6
FLOOR = 1e-30
NORM = 2.0 ** -14


def ssd_inputs(b: int, L: int, H: int, G: int, N: int, dh: int, dtype: torch.dtype,
               device, seed: int = 0, initial: bool = True,
               decay: Optional[tuple[float, float]] = None) -> dict:
    """The scan's operands as ``ssm_block_apply`` passes them: x [b, L, H,
    dh], B and C [b, L, G, N] as split views of one conv output, dt [b, L,
    H] and A [H] in f32, an initial state [b, H, N, dh] in f32 (None
    without ``initial``).  ``decay`` None draws A = -exp(U(0, ln 112))
    and dt log-uniform in [1e-3, 1e-1] (the published Zamba2's ranges),
    else (A, dt) for every head and position."""
    g = torch.Generator().manual_seed(seed)
    di, gn = H * dh, G * N
    conv = torch.randn((b, L, di + 2 * gn), generator=g).to(dtype).to(device)
    x, Bm, Cm = torch.split(conv, [di, gn, gn], dim=-1)
    if decay is None:
        A = -torch.exp(torch.rand((H,), generator=g) * torch.log(torch.tensor(112.0)))
        dt = torch.exp(torch.empty((b, L, H)).uniform_(-6.9078, -2.3026, generator=g))
    else:
        A = torch.full((H,), float(decay[0]))
        dt = torch.full((b, L, H), float(decay[1]))
    s0 = torch.randn((b, H, N, dh), generator=g) if initial else None
    return dict(x=x.reshape(b, L, H, dh), dt=dt.to(device), A=A.to(device),
                Bm=Bm.reshape(b, L, G, N), Cm=Cm.reshape(b, L, G, N),
                initial_state=None if s0 is None else s0.to(device))


def _intra_abs(ops: dict, chunk: int, dtype: torch.dtype) -> torch.Tensor:
    """The intra-chunk terms' magnitudes: each chunk's scan of the
    absolute operands from a zero state."""
    L = ops["x"].shape[1]
    ys = []
    for c0 in range(0, L, chunk):
        c = slice(c0, c0 + chunk)
        y, _ = ssm.ssd_chunked_plain(ops["x"][:, c].abs(), ops["dt"][:, c], ops["A"],
                                     ops["Bm"][:, c].abs(), ops["Cm"][:, c].abs(), chunk,
                                     None, dtype)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _ratio(diff: torch.Tensor, bound: torch.Tensor) -> float:
    return float((diff / bound).max()) if diff.numel() else 0.0


def agreement(got: tuple, ops: dict, chunk: int) -> dict:
    """``got`` (y, final state) against the plain scan of the same
    operands: the largest |difference| over its bound for y and for the
    state, the norm of y's difference over its bound (each <= 1 where the
    kernel holds), the norm of y's difference over the norm of all its
    terms' magnitudes, y's largest |difference|, and whether y and the
    state are bit-equal."""
    dtype = ops["x"].dtype
    want = ssm.ssd_chunked_plain(**ops, chunk=chunk, compute_dtype=dtype)
    s0 = ops["initial_state"]
    mags = ssm.ssd_chunked_plain(
        ops["x"].abs(), ops["dt"], ops["A"], ops["Bm"].abs(), ops["Cm"].abs(), chunk,
        None if s0 is None else s0.abs(), dtype)
    bound_y = SUM_ORDER * mags[0] + FLOOR
    norm_bound = SUM_ORDER * float(mags[0].norm()) + FLOOR
    if dtype == torch.bfloat16:
        intra = _intra_abs(ops, chunk, dtype)
        bound_y = bound_y + BF16_FLIP * intra
        norm_bound += NORM * float(intra.norm())
    dy = (got[0] - want[0]).abs()
    return dict(
        y=_ratio(dy, bound_y),
        state=_ratio((got[1] - want[1]).abs(), SUM_ORDER * mags[1] + FLOOR),
        norm=float(dy.norm()) / norm_bound,
        y_rel=float(dy.norm() / mags[0].norm()) if dy.numel() else 0.0,
        max_abs=float(dy.max()) if dy.numel() else 0.0,
        equal=bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
    )


def holds(r: dict) -> bool:
    """The kernel holds the bound: per element for y and the state, and
    in the norm."""
    return r["y"] <= 1 and r["state"] <= 1 and r["norm"] <= 1
