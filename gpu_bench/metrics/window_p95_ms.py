"""The 95th percentile over the traced windows of each window's device
extent: from the start of the first device operation launched in the window
to the end of its last (each window ends in a synchronize, so its device
work lies inside its span)."""

import math

from harness import trace


def read(record):
    ops = sorted((s, e) for s, e, _, _ in record["trace"]["device"])
    extents = []
    i = 0
    for lo, hi in record["trace"]["windows"]:
        while i < len(ops) and ops[i][0] < lo:
            i += 1
        inside = []
        while i < len(ops) and ops[i][0] <= hi:
            inside.append(ops[i])
            i += 1
        if inside:
            extents.append(max(e for _, e in inside) - inside[0][0])
    if not extents:
        return None
    extents.sort()
    return extents[max(0, math.ceil(0.95 * len(extents)) - 1)] * 1e-3
