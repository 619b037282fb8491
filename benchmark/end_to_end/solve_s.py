"""Time to a solved controller: the window's whole elapsed time (the solve
in flight at its end finished and counted) over the solves it
completed."""


def read(w):
    return w.elapsed / len(w.units) if w.units else None
