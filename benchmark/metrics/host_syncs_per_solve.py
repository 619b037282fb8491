"""Times a solve makes the host wait for the device: the runtime's
stream, device and event synchronizes and synchronous copies inside the
port's call, from the profiler, per solve. A count that repeats exactly."""

from benchmark.tracing import SYNC_NAMES

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "syncs"
MOVES = "solve_s"
SPANS = ("ocdp_tpu_torch.engine:value_iteration_converged_batch",
         "ocdp_tpu_torch.engine:value_iteration_finite",
         "ocdp_tpu_torch.engine:convergence_stop")


def read(t):
    if not t.requests:
        return None
    return sum(t.runtime.get(n, 0) for n in SYNC_NAMES) / t.requests
