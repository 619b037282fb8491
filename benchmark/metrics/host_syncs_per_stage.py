"""Times a control stage makes the host wait for the device (the
runtime's synchronizes and synchronous copies inside
``pos_att._closed_loop``, from the profiler), over the stages flown. The
target orbit's Kepler solve reads its Newton flag every 3 iterations
(``dynamics/orbital.py``)."""

from benchmark.tracing import SYNC_NAMES

LAYER = "rollouts: closed loop, integrators, dynamics"
UNIT = "syncs"
MOVES = "flight_s_per_s"
LOOP = "pos_att._closed_loop"
SPANS = ("ocdp_tpu_torch.models.pos_att:_closed_loop",
         "ocdp_tpu_torch.dynamics.orbital:kepler_universal")


def read(t):
    stages = sum(ctx["stages"] for ctx in t.context)
    if not stages:
        return None
    return sum(t.in_span.get((LOOP, n), 0) for n in SYNC_NAMES) / stages
