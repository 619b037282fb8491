"""Kernel launches (and CUDA graph launches) a control stage of a fleet:
the runtime's launch calls inside ``pos_att._closed_loop``, from the
profiler, over the stages it flew. The traced run profiles one fleet of
the mix's ``trace.set.t_final`` (0.5 s: 100 stages); the few launches before
and after the stage loop are counted with the stages."""

from benchmark.tracing import LAUNCH_NAMES

LAYER = "rollouts: closed loop, integrators, dynamics"
UNIT = "launches"
MOVES = "flight_s_per_s"
LOOP = "pos_att._closed_loop"
SPANS = ("ocdp_tpu_torch.models.pos_att:_closed_loop",
         "ocdp_tpu_torch.models.pos_att:_lookup_forces",
         "ocdp_tpu_torch.utils.integrators:_rk4_span")


def read(t):
    stages = sum(ctx["stages"] for ctx in t.context)
    if not stages:
        return None
    return sum(t.in_span.get((LOOP, n), 0) for n in LAUNCH_NAMES) / stages
