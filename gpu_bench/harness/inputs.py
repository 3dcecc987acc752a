"""The benchmark's inputs, drawn on the device from ``--seed``.

A copy of the distributions of ``tiger_tpu_torch/scenario.py::
scenario_arrays`` (the synthetic basin: parameters at +-``spread`` around
base values, the planted stiff rows spread evenly with their own capacity
and a strictly positive temperature, uniform rain and temperature), drawn
with a ``torch.Generator`` on the inputs' device in a few large calls
instead of from a fixed NumPy seed on the host.

Every seed runs the same basin, drawn from the traffic's ``basin_seed``:
the run's seed draws the forcing, so that seeds differ in the weather and
not in the systems a window integrates (a basin drawn anew per seed moved
B1's longest chain, the planted rows', by a few percent from seed to seed).
Each forcing's samples are drawn by their place in the stream: the block
of samples that window k reads is drawn from (seed, forcing, its first
sample's index) alone, so a window's inputs repeat whatever ran before it,
the reference regenerates them for the rows it integrates, and a sample
longer than the window (a day's temperature in hourly windows) is the same
in every window it covers.

Everything here is read from the traffic mix's file: a later mix changes
sizes, distributions or the check's sample by data alone.
"""

from __future__ import annotations

import hashlib
import math

import torch


def stream_seed(seed: int, *labels) -> int:
    """A 63-bit seed for the draw ``labels`` of the run ``seed``."""
    text = ":".join(str(x) for x in (int(seed), *labels))
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8).digest(), "little") >> 1


def forcing_layout(traffic: dict) -> tuple[tuple, tuple, tuple]:
    """(offsets, samples, dt_minutes) of the window's packed forcing block:
    each forcing's samples over the window, stacked in the traffic's order.

    A window holds whole samples, or lies inside one: the program reads the
    block's samples from the window's start, so a window and a sample must
    not straddle each other's boundaries."""
    offsets, samples, dts = [], [], []
    row = 0
    length = float(traffic["window_minutes"])
    for f in traffic["forcing"]:
        dt = float(f["dt_minutes"])
        ratio = length / dt if length >= dt else dt / length
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(f"forcing {f['name']}: a {dt} min sample and a {length} min "
                             "window straddle each other's boundaries")
        n = max(1, math.ceil(length / dt - 1e-9))
        offsets.append(row)
        samples.append(n)
        dts.append(dt)
        row += n
    return tuple(offsets), tuple(samples), tuple(dts)


def stiff_rows(traffic: dict) -> torch.Tensor:
    """The planted stiff rows, spread evenly (``scenario_arrays``' rule)."""
    n, share = int(traffic["links"]), float(traffic["stiff_share"])
    count = int(round(n * share))
    if not count:
        return torch.zeros(0, dtype=torch.int64)
    return torch.linspace(0, n - 1, count, dtype=torch.float64).to(torch.int64)


class Inputs:
    """Parameters, planted rows and per-window forcing of one run."""

    def __init__(self, traffic: dict, param_fields, seed: int, device, dtype):
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = int(traffic["links"])
        self.stiff = stiff_rows(traffic).to(self.device)
        self.offsets, self.samples, self.dt = forcing_layout(traffic)
        self.gen = torch.Generator(device=self.device)
        spec = traffic["params"]
        base = torch.tensor([float(spec["base"][k]) for k in param_fields], dtype=dtype,
                            device=self.device)
        self.gen.manual_seed(stream_seed(spec["basin_seed"], "basin"))
        u = torch.rand((len(param_fields), self.n), generator=self.gen, dtype=dtype,
                       device=self.device)
        spread = float(spec["spread"])
        block = base[:, None] * (1.0 - spread + 2.0 * spread * u)
        for key, value in spec.get("stiff", {}).items():
            block[list(param_fields).index(key), self.stiff] = value
        self.params = {k: block[i] for i, k in enumerate(param_fields)}

    def window_start(self, k: int) -> float:
        """The start of window k in minutes from the stream's start: the
        program's ``t_shift`` and the reference's ``t0``."""
        return k * float(self.traffic["window_minutes"])

    def first_sample(self, k: int, j: int) -> int:
        """The index, from the stream's start, of forcing j's first sample in window k."""
        return int(math.floor(self.window_start(k) / self.dt[j] + 1e-9))

    def forcing(self, k: int) -> torch.Tensor:
        """Window k's packed forcing block [T, S] (float32) on the device."""
        data = torch.empty((sum(self.samples), self.n), dtype=torch.float32, device=self.device)
        for j, (f, off, count) in enumerate(zip(self.traffic["forcing"], self.offsets,
                                                self.samples)):
            self.gen.manual_seed(stream_seed(self.seed, f["name"], self.first_sample(k, j)))
            u = torch.rand((count, self.n), generator=self.gen, device=self.device)
            lo, hi = float(f["low"]), float(f["high"])
            block = lo + (hi - lo) * u
            if "stiff_low" in f and self.stiff.numel():
                s_lo, s_hi = float(f["stiff_low"]), float(f["stiff_high"])
                block[:, self.stiff] = s_lo + (s_hi - s_lo) * u[:, self.stiff]
            data[off:off + count] = block
        return data
