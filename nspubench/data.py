"""The cells' time series: synthetic doubles of the paper's UCR datasets.

A frozen copy of the port's ``data/ucr.py`` generator (``make_synthetic``
and its size table), so that a later change to the program cannot move
the benchmark's inputs.  The UCR archive is not in the repository; each
double matches its dataset's length, class count and sample count (to
the nearest whole number of series per class) and modality.
"""
from __future__ import annotations

import zlib

import numpy as np

# (length, classes, series, modality) per paper Table II.
BENCHMARKS = {
    "SonyAIBORobotSurface2": dict(length=65, classes=2, n=980, modality="accelerometer"),
    "ECG200": dict(length=96, classes=2, n=200, modality="ecg"),
    "Wafer": dict(length=152, classes=2, n=1000, modality="fabrication"),
    "ToeSegmentation2": dict(length=343, classes=2, n=166, modality="motion"),
    "Lightning2": dict(length=637, classes=2, n=121, modality="optical_rf"),
    "Beef": dict(length=470, classes=5, n=60, modality="spectrograph"),
    "WordSynonyms": dict(length=270, classes=25, n=905, modality="word_outline"),
}


def _class_prototype(rng: np.random.Generator, n: int, modality: str) -> np.ndarray:
    t = np.linspace(0, 1, n)
    if modality in ("accelerometer", "motion"):
        proto = np.zeros(n)
        for _ in range(3):
            c, wdt, amp = rng.uniform(0.1, 0.9), rng.uniform(0.03, 0.15), rng.normal(0, 2)
            proto += amp * np.exp(-0.5 * ((t - c) / wdt) ** 2)
        proto += rng.normal(0, 0.5) * t
    elif modality == "ecg":
        proto = np.zeros(n)
        spike_pos = rng.uniform(0.2, 0.8)
        proto += rng.uniform(2, 4) * np.exp(-0.5 * ((t - spike_pos) / 0.02) ** 2)
        proto -= rng.uniform(0.5, 1.5) * np.exp(-0.5 * ((t - spike_pos - 0.05) / 0.03) ** 2)
        proto += 0.3 * np.sin(2 * np.pi * rng.integers(1, 4) * t)
    elif modality in ("fabrication", "spectrograph"):
        proto = np.cumsum(rng.normal(0, 0.15, n))
        for _ in range(2):
            a, b = sorted(rng.uniform(0, 1, 2))
            proto += rng.normal(0, 1.5) * ((t > a) & (t < b))
    elif modality == "optical_rf":
        proto = rng.uniform(0.5, 2) * np.sin(
            2 * np.pi * rng.uniform(2, 8) * t + rng.uniform(0, 2 * np.pi)
        ) * np.exp(-rng.uniform(0, 3) * t)
    else:
        proto = np.zeros(n)
        for k in range(1, 6):
            proto += rng.normal(0, 1.0 / k) * np.sin(2 * np.pi * k * t + rng.uniform(0, 6.28))
    return proto


def make_synthetic(name: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(series [N, L] float64, labels [N] int64) of the double of ``name``:
    a shared background, one prototype per class, then per series a time
    warp, a shift, an amplitude scale and heavy noise, shuffled."""
    meta = BENCHMARKS[name]
    rng = np.random.default_rng((zlib.crc32(name.encode()) + int(seed)) % 2**32)
    length, k, n = meta["length"], meta["classes"], meta["n"]
    background = _class_prototype(rng, length, meta["modality"]) * 1.5
    protos = [_class_prototype(rng, length, meta["modality"]) for _ in range(k)]
    xs, ys = [], []
    per = max(n // k, 8)
    grid = np.linspace(0, 1, length)
    for c in range(k):
        warp = rng.uniform(0.9, 1.1, size=per)
        shift = rng.integers(-length // 20 - 1, length // 20 + 1, size=per)
        for i in range(per):
            tt = np.clip(grid * warp[i], 0, 1)
            base = background + np.interp(tt, grid, protos[c])
            base = np.roll(base, int(shift[i]))
            xs.append(base * rng.uniform(0.7, 1.3) + rng.normal(0, 0.6, length))
            ys.append(c)
    x = np.stack(xs)
    y = np.asarray(ys, np.int64)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def stream(name: str, seed: int, n: int, length: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``n`` series of the double of ``name``, cut to their first
    ``length`` samples: the sizes a configuration states (the whole
    double at its published sizes)."""
    x, y = make_synthetic(name, seed)
    if n > x.shape[0] or length > x.shape[1]:
        raise ValueError(f"{name}: the double holds {x.shape}, asked for ({n}, {length})")
    return x[:n, :length], y[:n]
