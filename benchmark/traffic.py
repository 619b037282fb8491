"""The one request generator: it reads a traffic mix (a JSON file of
parameters under ``benchmark/traffic/``) and draws every request's inputs
from ``--seed``, so the same seed gives the same requests. A new mix is a
new data file: what a request holds is named in the mix, drawn by one of
the general kinds below, and handed to its entry as it is.

A mix's keys:

* ``entry``: the port's entry point a request calls (a module under
  ``benchmark/entries/`` of that name);
* ``fixed``: parameters every request carries unchanged;
* ``draws``: the parameters drawn afresh for each request, in order, each
  ``{"kind": ...}`` of

  - ``scale``: the configuration's value of that name (or of ``of``),
    each component multiplied by a factor uniform in
    ``[1 - spread, 1 + spread]``; a float or a list;
  - ``uniform``: uniform in ``[low, high]``, component by component;
  - ``normal``: ``mean`` plus normal noise of ``sigma`` (a number or one
    per component);

  ``uniform`` and ``normal`` give a numpy array of ``dtype`` (float64 by
  default), of ``rows`` rows when given (a batch: a fleet's starts);
* ``warmup``: the set-up requests: ``count`` of them, each with every draw
  at its centre (the configuration's value, ``mean``, or the middle of
  ``[low, high]``), then ``set`` over them;
* ``trace``: the traced run's profiled requests: ``requests`` of them,
  drawn as the window's are from a stream of their own, then ``set``;
* ``check``: how many of the window's requests the reference judges
  (``sample``, drawn from the seed) and each number's ``limits``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Generator", "KINDS"]


def _scale(spec, name, config, rng):
    base = np.asarray(config[spec.get("of", name)], np.float64)
    f = rng.uniform(1.0 - spec["spread"], 1.0 + spec["spread"], base.shape) \
        if rng else np.ones(base.shape)
    v = base * f
    return float(v) if v.ndim == 0 else [float(x) for x in v]


def _batch(spec, centre):
    c = np.asarray(centre, np.float64)
    if "rows" in spec:
        c = np.tile(c, (spec["rows"],) + (1,) * c.ndim)
    return c.astype(spec.get("dtype", "float64"))


def _uniform(spec, name, config, rng):
    lo = _batch(spec, spec["low"])
    hi = _batch(spec, spec["high"])
    if not rng:
        return ((lo.astype(np.float64) + hi) / 2).astype(lo.dtype)
    return rng.uniform(lo.astype(np.float64), hi).astype(lo.dtype)


def _normal(spec, name, config, rng):
    x = _batch(spec, spec["mean"])
    if rng:
        x = x + rng.normal(0.0, spec["sigma"], x.shape).astype(x.dtype)
    return x


KINDS = {"scale": _scale, "uniform": _uniform, "normal": _normal}


class Generator:
    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.config = config
        self.seed = seed
        self.rng = np.random.default_rng([seed, 0])

    def _params(self, rng, extra=None) -> dict:
        p = dict(self.mix.get("fixed", {}))
        for name, spec in self.mix.get("draws", {}).items():
            p[name] = KINDS[spec["kind"]](spec, name, self.config, rng)
        p.update(extra or {})
        return p

    def next(self) -> dict:
        """The next request's inputs."""
        return self._params(self.rng)

    def warmups(self) -> list:
        """The set-up requests: every draw at its centre."""
        w = self.mix.get("warmup", {})
        return [self._params(None, w.get("set"))
                for _ in range(w.get("count", 1))]

    def traced(self) -> list:
        """The traced run's profiled requests, drawn like the window's."""
        t = self.mix.get("trace", {})
        rng = np.random.default_rng([self.seed, 1])
        return [self._params(rng, t.get("set"))
                for _ in range(t.get("requests", 3))]
