"""The 90th percentile of the latency of every solve in the window (the
highest percentile with ten or more solves beyond it at 100 or more
solves a window)."""

import statistics


def read(w):
    if len(w.latencies) < 2:
        return None
    return statistics.quantiles(w.latencies, n=10, method="inclusive")[-1]
