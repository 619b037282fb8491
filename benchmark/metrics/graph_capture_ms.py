"""Host time a solve spends building ``engine.SweepGraph``s (the CUDA graph
capture, with ``torch.cuda.graph``'s garbage collection and cache flush),
each ended by a synchronize (the timing pass), per solve."""

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "ms"
MOVES = "solve_s"
TIMED = ("ocdp_tpu_torch.engine:SweepGraph",)
SPANS = TIMED


def read(t):
    if not t.timed_requests or not t.timed_calls.get(TIMED[0]):
        return None
    return 1e3 * t.timed.get(TIMED[0], 0.0) / t.timed_requests
