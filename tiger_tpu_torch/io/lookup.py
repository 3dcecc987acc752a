"""Stream -> grid-cell lookup table (forcing remap).

A copy of ``tiger_tpu/io/lookup.py`` (numpy only).  Reference: LookupMapper
(src/I_O/forcing_loader.cpp:14-64) reads a CSV with header
``stream,lat_index,lon_index`` into a hashmap; the main program computes
one flat grid index per system: streamPoint[s] = lat_idx * lon_size + lon_idx
(main.cpp:495-505).  Vectorized here: one numpy join instead of S hash lookups.
"""

from __future__ import annotations

import numpy as np


class LookupTable:
    def __init__(self, stream_ids: np.ndarray, lat_idx: np.ndarray, lon_idx: np.ndarray):
        self.stream_ids = np.asarray(stream_ids, np.int64)
        self.lat_idx = np.asarray(lat_idx, np.int64)
        self.lon_idx = np.asarray(lon_idx, np.int64)
        order = np.argsort(self.stream_ids, kind="stable")
        self._sorted_ids = self.stream_ids[order]
        self._order = order

    @staticmethod
    def load(csv_path: str) -> "LookupTable":
        data = np.loadtxt(csv_path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
        if data.shape[1] < 3:
            raise ValueError(f"Lookup CSV {csv_path} needs stream,lat_index,lon_index")
        return LookupTable(data[:, 0], data[:, 1], data[:, 2])

    def __len__(self) -> int:
        return len(self.stream_ids)

    def flat_index(self, streams: np.ndarray, lon_size: int) -> np.ndarray:
        """Per-system flat grid index lat*lon_size + lon for the given stream ids.

        Raises KeyError listing missing ids (the reference silently returns a
        default-constructed (0, 0) pair for unknown streams — an easy way to
        read the wrong grid cell, so we fail loudly instead).
        """
        streams = np.asarray(streams, np.int64)
        pos = np.searchsorted(self._sorted_ids, streams)
        pos_clip = np.clip(pos, 0, len(self._sorted_ids) - 1)
        found = self._sorted_ids[pos_clip] == streams
        if not found.all():
            missing = streams[~found][:10]
            raise KeyError(f"Streams missing from lookup table (first 10): {missing}")
        rows = self._order[pos_clip]
        lat = self.lat_idx[rows]
        lon = self.lon_idx[rows]
        # Per-axis validation: lon_idx >= lon_size (or negative indices)
        # would otherwise ALIAS into a neighboring grid row while staying
        # inside the flattened bound the downstream check tests.
        bad = (lon < 0) | (lon >= lon_size) | (lat < 0)
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} lookup row(s) have lon_index outside "
                f"[0, {lon_size}) or negative lat_index (first streams: "
                f"{streams[bad][:10]})"
            )
        return lat * lon_size + lon
