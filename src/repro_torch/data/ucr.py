"""UCR time-series archive access (paper §III-A).

``load(name)`` reads the real UCR 2018 ``.tsv`` format if a local archive is
available (env ``UCR_ROOT`` or ./data/UCR); otherwise it falls back to
*synthetic doubles* — generated datasets matching each benchmark's length,
class count, sample count and qualitative character (modality-appropriate
waveform families).  The paper's own rand-index numbers are kept as
reference constants so benchmarks can report both "paper" and "ours".
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional

import numpy as np

# (length, n_classes, n_train+test used, modality) per paper Table II.
BENCHMARKS = {
    "SonyAIBORobotSurface2": dict(length=65, classes=2, n=980, modality="accelerometer"),
    "ECG200": dict(length=96, classes=2, n=200, modality="ecg"),
    "Wafer": dict(length=152, classes=2, n=1000, modality="fabrication"),
    "ToeSegmentation2": dict(length=343, classes=2, n=166, modality="motion"),
    "Lightning2": dict(length=637, classes=2, n=121, modality="optical_rf"),
    "Beef": dict(length=470, classes=5, n=60, modality="spectrograph"),
    "WordSynonyms": dict(length=270, classes=25, n=905, modality="word_outline"),
}

# Paper Table II rand indices (normalized to k-means), for reference output.
PAPER_RAND_INDEX = {
    "SonyAIBORobotSurface2": dict(dtcr=0.8354, tnn=0.6066),
    "ECG200": dict(dtcr=0.6648, tnn=0.6648),
    "Wafer": dict(dtcr=0.7338, tnn=0.555),
    "ToeSegmentation2": dict(dtcr=0.8286, tnn=0.6683),
    "Lightning2": dict(dtcr=0.5913, tnn=0.577),
    "Beef": dict(dtcr=0.8046, tnn=0.731),
    "WordSynonyms": dict(dtcr=0.8984, tnn=0.8473),
}

# Table II column geometries (p x q); p = series length, q = neurons.
PAPER_COLUMNS = {
    "SonyAIBORobotSurface2": (65, 2),
    "ECG200": (96, 2),
    "Wafer": (152, 2),
    "ToeSegmentation2": (343, 2),
    "Lightning2": (637, 2),
    "Beef": (470, 5),
    "WordSynonyms": (270, 25),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x: np.ndarray  # [N, L]
    y: np.ndarray  # [N]
    synthetic: bool

    @property
    def n_classes(self) -> int:
        return len(np.unique(self.y))


def _ucr_root() -> Optional[str]:
    for cand in (os.environ.get("UCR_ROOT"), "data/UCR"):
        if cand and os.path.isdir(cand):
            return cand
    return None


def _load_real(root: str, name: str) -> Optional[Dataset]:
    rows = []
    for split in ("TRAIN", "TEST"):
        path = os.path.join(root, name, f"{name}_{split}.tsv")
        if not os.path.exists(path):
            return None
        rows.append(np.loadtxt(path, delimiter="\t"))
    data = np.concatenate(rows, axis=0)
    return Dataset(name, data[:, 1:], data[:, 0].astype(np.int64), synthetic=False)


def _class_prototype(rng: np.random.Generator, L: int, modality: str) -> np.ndarray:
    """Modality-flavored smooth prototype waveform."""
    t = np.linspace(0, 1, L)
    if modality in ("accelerometer", "motion"):
        # bursts + piecewise trends
        proto = np.zeros(L)
        for _ in range(3):
            c, wdt, amp = rng.uniform(0.1, 0.9), rng.uniform(0.03, 0.15), rng.normal(0, 2)
            proto += amp * np.exp(-0.5 * ((t - c) / wdt) ** 2)
        proto += rng.normal(0, 0.5) * t
    elif modality == "ecg":
        # QRS-like spike train with class-specific morphology
        proto = np.zeros(L)
        spike_pos = rng.uniform(0.2, 0.8)
        proto += rng.uniform(2, 4) * np.exp(-0.5 * ((t - spike_pos) / 0.02) ** 2)
        proto -= rng.uniform(0.5, 1.5) * np.exp(-0.5 * ((t - spike_pos - 0.05) / 0.03) ** 2)
        proto += 0.3 * np.sin(2 * np.pi * rng.integers(1, 4) * t)
    elif modality in ("fabrication", "spectrograph"):
        # plateaus / absorption-band shapes
        proto = np.cumsum(rng.normal(0, 0.15, L))
        for _ in range(2):
            a, b = sorted(rng.uniform(0, 1, 2))
            proto += rng.normal(0, 1.5) * ((t > a) & (t < b))
    elif modality == "optical_rf":
        proto = rng.uniform(0.5, 2) * np.sin(
            2 * np.pi * rng.uniform(2, 8) * t + rng.uniform(0, 2 * np.pi)
        ) * np.exp(-rng.uniform(0, 3) * t)
    else:  # word_outline and default: band-limited random shapes
        proto = np.zeros(L)
        for k in range(1, 6):
            proto += rng.normal(0, 1.0 / k) * np.sin(2 * np.pi * k * t + rng.uniform(0, 6.28))
    return proto


def make_synthetic(name: str, seed: int = 0) -> Dataset:
    """Synthetic double of a UCR benchmark (see module docstring)."""
    if name not in BENCHMARKS:
        raise KeyError(f"unknown benchmark {name!r}")
    meta = BENCHMARKS[name]
    # zlib.crc32, not hash(): str hashing is randomized per process
    # (PYTHONHASHSEED), which made the "deterministic" doubles differ
    # between runs — benchmarks were not comparable across invocations.
    rng = np.random.default_rng((zlib.crc32(name.encode()) + seed) % 2**32)
    L, k, n = meta["length"], meta["classes"], meta["n"]
    # Shared background component makes classes overlap (as real UCR data
    # does); per-class prototypes sit on top of it.
    background = _class_prototype(rng, L, meta["modality"]) * 1.5
    protos = [_class_prototype(rng, L, meta["modality"]) for _ in range(k)]
    xs, ys = [], []
    per = max(n // k, 8)
    for c in range(k):
        warp = rng.uniform(0.9, 1.1, size=per)
        shift = rng.integers(-L // 20 - 1, L // 20 + 1, size=per)
        for i in range(per):
            # time-warp + shift + amplitude scale + heavy noise
            tt = np.clip(np.linspace(0, 1, L) * warp[i], 0, 1)
            base = background + np.interp(tt, np.linspace(0, 1, L), protos[c])
            base = np.roll(base, int(shift[i]))
            xs.append(base * rng.uniform(0.7, 1.3) + rng.normal(0, 0.6, L))
            ys.append(c)
    x = np.stack(xs)
    y = np.asarray(ys, np.int64)
    perm = rng.permutation(len(y))
    return Dataset(name, x[perm], y[perm], synthetic=True)


def load(name: str, seed: int = 0) -> Dataset:
    """Real UCR data if available, else the synthetic double."""
    root = _ucr_root()
    if root:
        ds = _load_real(root, name)
        if ds is not None:
            return ds
    return make_synthetic(name, seed)
