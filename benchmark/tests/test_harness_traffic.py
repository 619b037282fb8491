"""The request generator: the same seed gives the same requests, another
seed others, and seeds past 32 bits work."""

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.tests.conftest import ALL, CELLS


def _draw(cell, seed, n=3):
    c = harness.load_cell(cell, device="cpu", bench=ALL)
    g = traffic.Generator(c.mix, c.config, seed)
    return [g.next() for _ in range(n)], g.traced(), g.warmups()


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 17, 2**31 + 12345])
def test_same_seed_same_requests(cell, seed):
    assert _same(_draw(cell, seed), _draw(cell, seed))


@pytest.mark.parametrize("cell", CELLS)
def test_seeds_differ(cell):
    a, _, _ = _draw(cell, 1)
    b, _, _ = _draw(cell, 2)
    assert not _same(a, b)
    assert not _same(a[0], a[1])


def test_weights_stay_within_the_spread():
    c = harness.load_cell("attitude6d-solve", device="cpu")
    g = traffic.Generator(c.mix, c.config, 5)
    for _ in range(20):
        p = g.next()
        for k in ("Qw", "Qq", "R"):
            base = np.asarray(c.config[k])
            assert np.all(np.abs(np.asarray(p[k]) / base - 1) <= 0.25)


def test_warmups_use_the_configuration():
    c = harness.load_cell("pos_att-solve", device="cpu")
    w = traffic.Generator(c.mix, c.config, 9).warmups()
    assert len(w) == 2 and all(p["Qx"] == c.config["Qx"] for p in w)
    f = harness.load_cell("pos_att-fleet", device="cpu", bench=ALL)
    w = traffic.Generator(f.mix, f.config, 9).warmups()
    assert np.array_equal(w[0]["x0s"][3], np.asarray(
        f.mix["draws"]["x0s"]["mean"], np.float32))
    assert w[0]["t_final"] == 0.05 and w[0]["integrator"] == "rk4"


def test_fleet_shape():
    reqs, traced, _ = _draw("pos_att-fleet", 4, 1)
    assert reqs[0]["x0s"].shape == (256, 13)
    assert reqs[0]["x0s"].dtype == np.float32
    assert traced[0]["t_final"] == 0.5 and reqs[0]["t_final"] == 10.0


def test_a_mix_of_new_draws_is_data_alone():
    """A mix that needs no code: single 6-D attitude flights from a start
    uniform within the grid's rate and angle ranges (deg/s, deg), as a
    later cell would draw them."""
    mix = {"entry": "attitude.rollout_full", "fixed": {"t_final": 30.0},
           "draws": {"x0": {"kind": "uniform",
                            "low": [-30, -30, -30, -40, -40, -40],
                            "high": [30, 30, 30, 40, 40, 40]}},
           "warmup": {"count": 1}, "trace": {"requests": 2}}
    g = traffic.Generator(mix, {}, 2**31 + 5)
    reqs = [g.next() for _ in range(50)]
    x = np.stack([r["x0"] for r in reqs])
    assert x.shape == (50, 6) and x.dtype == np.float64
    assert np.all(x >= mix["draws"]["x0"]["low"])
    assert np.all(x <= mix["draws"]["x0"]["high"])
    assert len({tuple(r) for r in x}) == 50
    assert np.array_equal(g.warmups()[0]["x0"], np.zeros(6))
    assert [r["t_final"] for r in g.traced()] == [30.0, 30.0]
    again = traffic.Generator(mix, {}, 2**31 + 5)
    assert np.array_equal(again.next()["x0"], reqs[0]["x0"])


def test_draw_kinds_are_the_generators_own():
    for name in ("pos_att-resolve", "attitude6d-resolve", "fleet256-rk4"):
        mix = harness.json.loads(
            (harness.HERE / "traffic" / f"{name}.json").read_text())
        assert {d["kind"] for d in mix["draws"].values()} <= set(traffic.KINDS)
