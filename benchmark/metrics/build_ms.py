"""Host time a solve spends in the models' plan and tap builds, each call
ended by a synchronize (the timing pass), per solve."""

LAYER = "models: plan and tap builds"
UNIT = "ms"
MOVES = "solve_s"
TIMED = ("ocdp_tpu_torch.models.pos_att:build_channel",
         "ocdp_tpu_torch.models.pos_att:build_channel_rowlane_backup",
         "ocdp_tpu_torch.models.attitude:build_full")
SPANS = TIMED


def read(t):
    if not t.timed_requests or not any(t.timed_calls.get(x) for x in TIMED):
        return None
    return 1e3 * sum(t.timed.get(x, 0.0) for x in TIMED) / t.timed_requests
