"""``reg_ms_p95``: the 95th percentile (nearest rank) of every request
completed in the window, each from its copy to the card until its outputs
are in host memory."""

import math


def read(run):
    if run.kind != "reg" or not run.latencies_s:
        return None
    lat = sorted(run.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
