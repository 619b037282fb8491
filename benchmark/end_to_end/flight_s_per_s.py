"""Simulated flight-seconds completed a wall second: every fleet's flight
seconds over the window's whole elapsed time (the fleet in flight at its
end finished and counted)."""


def read(w):
    return sum(w.units) / w.elapsed if w.units else None
