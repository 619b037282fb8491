"""The device's idle share over the profiled requests: 1 - the union of
its kernel and copy intervals over the requests' wall (each from the
port's call to the end of the synchronize after it)."""

LAYER = "device"
UNIT = "%"
MOVES = "solve_s"


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
