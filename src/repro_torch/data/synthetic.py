"""Synthetic stand-ins for the paper's eight datasets (Table 1) — a
numpy/scipy copy of ``repro/data/synthetic.py``, so the port makes the same
series from the same seed without importing the JAX package.

No dataset is downloaded: each generator reproduces the *structural*
properties the paper's experiments depend on: length, sampling granularity,
seasonal periods (the ACF/PACF signature), noise level, value range, and the
oddities called out in Table 1 (SolarPower's 75% repeated values at night,
Pedestrian's non-negative counts).  Lags/kappa per dataset follow the
paper's "ACF #Lag" column ("7 on 48" = 7 lags on kappa=48 aggregates).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    length: int
    lags: int
    kappa: int          # 1 = raw-ACF group; >1 = SIP-on-aggregates group
    description: str


DATASETS: Dict[str, DatasetSpec] = {
    "elec_power": DatasetSpec("elec_power", 2976, 48, 1,
                              "household power, 15-min, daily cycle"),
    "min_temp": DatasetSpec("min_temp", 3650, 365, 1,
                            "daily min temperature, yearly cycle"),
    "pedestrian": DatasetSpec("pedestrian", 8760, 24, 1,
                              "hourly counts, daily+weekly cycles"),
    "uk_elec": DatasetSpec("uk_elec", 17520, 48, 1,
                           "half-hourly national demand, daily cycle"),
    "aus_elec": DatasetSpec("aus_elec", 230688, 7, 48,
                            "half-hourly demand, 7 lags on 48-aggregates"),
    "humidity": DatasetSpec("humidity", 397440, 24, 60,
                            "1-min humidity, 24 lags on hourly aggregates"),
    "ir_bio_temp": DatasetSpec("ir_bio_temp", 878400, 24, 60,
                               "1-min IR surface temperature"),
    "solar": DatasetSpec("solar", 986160, 24, 120,
                         "30-sec solar power, zero at night"),
}


def _season(t, period, harmonics=2):
    out = np.zeros_like(t, dtype=np.float64)
    for h in range(1, harmonics + 1):
        out += np.cos(2 * np.pi * h * t / period) / h
    return out


def _ar1(rng, n, phi=0.7, sigma=1.0):
    from scipy.signal import lfilter
    e = rng.standard_normal(n) * sigma
    return lfilter([1.0], [1.0, -phi], e)


def make_dataset(name: str, seed: int = 0, length: int | None = None) -> np.ndarray:
    spec = DATASETS[name]
    n = length or spec.length
    # stable per-name offset: Python's str hash is salted per process, which
    # made "deterministic" datasets differ between runs (and benchmark CRs
    # drift across invocations) — crc32 is reproducible everywhere.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    t = np.arange(n, dtype=np.float64)

    if name == "elec_power":
        x = 1.2 + 0.8 * _season(t, 96) + 0.3 * _ar1(rng, n, 0.6, 0.4)
        x += (rng.random(n) < 0.02) * rng.exponential(2.0, n)  # spikes
        return np.maximum(x, 0.05)
    if name == "min_temp":
        x = 11.0 + 6.0 * _season(t, 365.25, 1) + _ar1(rng, n, 0.7, 1.6)
        return x
    if name == "pedestrian":
        base = 400 + 380 * _season(t, 24) + 150 * _season(t, 168, 1)
        x = np.maximum(base + _ar1(rng, n, 0.5, 90.0), 0.0)
        return np.round(x)
    if name == "uk_elec":
        x = 27000 + 5200 * _season(t, 48) + 1500 * _season(t, 336, 1) \
            + _ar1(rng, n, 0.85, 450.0)
        return x
    if name == "aus_elec":
        x = 6800 + 1100 * _season(t, 48) + 400 * _season(t, 336, 1) \
            + _ar1(rng, n, 0.8, 120.0)
        return x
    if name == "humidity":
        x = 76 + 15 * _season(t, 1440) + _ar1(rng, n, 0.95, 0.8)
        return np.clip(x, 10.0, 100.0)
    if name == "ir_bio_temp":
        x = 23 + 7.5 * _season(t, 1440) + 2.0 * _season(t, 1440 * 30, 1) \
            + _ar1(rng, n, 0.9, 0.5)
        return x
    if name == "solar":
        day = 2880  # 30-sec samples per day
        phase = (t % day) / day
        daylight = np.clip(np.sin(np.pi * (phase - 0.25) / 0.5), 0.0, None)
        cloud = np.clip(1.0 - 0.35 * np.abs(_ar1(rng, n, 0.98, 0.12)), 0.1, 1.0)
        x = 110.0 * daylight * cloud
        x[x < 1.0] = 0.0  # night: exact repeated zeros (p_= = 75%)
        return x
    raise KeyError(name)


def dataset_cameo_kwargs(name: str) -> dict:
    spec = DATASETS[name]
    return dict(lags=spec.lags, kappa=spec.kappa)
