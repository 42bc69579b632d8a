"""Device/network heterogeneity models fit to the paper's testbed data.

A numpy copy of ``repro.sim.hardware``: the same draws in the same order
from the same ``np.random.Generator``.

Paper §2.3 + Fig. 3 (Raspberry Pi 4, conservative governor 0.6–1.5 GHz,
stress-ng interference 5–95%): per-SGD-epoch time and energy both grow
superlinearly with background CPU usage and fluctuate strongly at fixed
usage. Fig. 4: edge→cloud time grows linearly with model size, with a
large region gap (Beijing vs Washington D.C. to a Silicon Valley cloud).

Calibration anchors (paper §4): 50 devices / 5 edges; CPU usage classes
{10..50}%; MNIST run 3000 s ≈ tens of cloud rounds at γ1·γ2 ≈ 20 with
device energies of a few hundred mAh — the constants below land in those
ranges.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# per-epoch compute cost (seconds / mAh) for the paper's two testbed tasks
TASK_BASE = {
    "mnist": {"t": 1.1, "e": 0.09},     # 21.8k-param CNN, 1200 samples
    "cifar": {"t": 4.2, "e": 0.36},     # 454k-param CNN, 1000 samples
}
MODEL_MB = {"mnist": 0.087, "cifar": 1.83}

# edge->cloud link model: time = lat + size_MB / bw  (Fig. 4)
REGIONS = {
    "cn": {"lat": 6.0, "bw": 0.9},      # Beijing -> Silicon Valley
    "us": {"lat": 1.2, "bw": 6.0},      # Washington D.C. -> Silicon Valley
}


@dataclasses.dataclass
class DeviceProfiles:
    """Static per-device characteristics + stochastic per-epoch sampling."""
    cpu_usage: np.ndarray        # background CPU usage fraction (0.05–0.95)
    freq: np.ndarray             # effective CPU frequency (GHz)
    flops: np.ndarray            # profiling-task MFLOP/s
    profile_time: np.ndarray     # T_pro (s)
    profile_energy: np.ndarray   # E_pro (mAh)
    task: str = "mnist"

    @staticmethod
    def sample(rng: np.random.Generator, n_devices: int, task: str = "mnist",
               usage_classes=(0.1, 0.2, 0.3, 0.4, 0.5)) -> "DeviceProfiles":
        """Paper §4.1: usage classes 10–50%, n/5 devices per class."""
        usage = np.repeat(np.asarray(usage_classes),
                          -(-n_devices // len(usage_classes)))[:n_devices]
        rng.shuffle(usage)
        freq = 1.5 - 0.9 * usage + rng.normal(0, 0.05, n_devices)
        flops = 220.0 * freq / 1.5 * (1 - 0.6 * usage)
        base = TASK_BASE[task]
        pt = base["t"] / (1.0 - usage) * rng.lognormal(0, 0.08, n_devices)
        pe = base["e"] * (1.0 + 1.8 * usage) * rng.lognormal(0, 0.08,
                                                             n_devices)
        return DeviceProfiles(cpu_usage=usage, freq=freq, flops=flops,
                              profile_time=pt, profile_energy=pe, task=task)

    def epoch_time(self, rng: np.random.Generator) -> np.ndarray:
        """Per-device seconds for one local epoch (Fig. 3a shape: mean
        rises ~1/(1-u), strong lognormal jitter from interference)."""
        base = TASK_BASE[self.task]["t"]
        jitter = rng.lognormal(0, 0.18, len(self.cpu_usage))
        return base / (1.0 - self.cpu_usage) * jitter

    def epoch_energy(self, rng: np.random.Generator) -> np.ndarray:
        """Per-device mAh for one local epoch (Fig. 3b: rises with usage —
        contention keeps the SoC busy longer at high power)."""
        base = TASK_BASE[self.task]["e"]
        jitter = rng.lognormal(0, 0.15, len(self.cpu_usage))
        return base * (1.0 + 1.8 * self.cpu_usage) * jitter


@dataclasses.dataclass
class CommModel:
    """Edge→cloud communication (device→edge LAN is ms-level — ignored,
    paper §2.3)."""
    edge_region: list            # region key per edge
    task: str = "mnist"

    def ec_time(self, rng: np.random.Generator) -> np.ndarray:
        """Per-edge upload+download seconds for one cloud sync."""
        size = MODEL_MB[self.task]
        out = np.empty(len(self.edge_region))
        for j, r in enumerate(self.edge_region):
            m = REGIONS[r]
            out[j] = (m["lat"] + 2.0 * size / m["bw"]) \
                * rng.lognormal(0, 0.12)
        return out

    def ec_time_edge(self, rng: np.random.Generator, edge: int) -> float:
        """One fresh edge→cloud sync draw for a single edge — the price
        of re-uploading after a transient failure (the async runtime's
        retry path). Same link model and
        jitter as :meth:`ec_time`, one draw instead of one per edge."""
        size = MODEL_MB[self.task]
        m = REGIONS[self.edge_region[edge]]
        return float((m["lat"] + 2.0 * size / m["bw"])
                     * rng.lognormal(0, 0.12))

    def de_time(self, rng: np.random.Generator, n_edges: int) -> np.ndarray:
        """Device→edge LAN per edge-sync (milliseconds)."""
        return rng.uniform(0.005, 0.02, n_edges)
