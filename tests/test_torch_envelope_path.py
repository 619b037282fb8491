"""The 6-D envelope path (flat recompute plan, carry mode, segments with
the ``rel`` stop rule and a checkpoint each), on the CPU at 5^3 x 4^3 with
9 sweeps in segments of 4 (checks after sweeps 2 and 6): ``solve_full``
forced onto that path, on seeded cost weights around the full 6-D
reference configuration's, against the blocked plain reference
(``benchmark/reference/attitude_envelope.py``); that reference, in blocks
smaller than the table, against the unblocked ``dp.solve``; the last
checkpoint read back; and a stop at the second check taken by both. This
file imports no jax:

    python -m pytest --noconftest tests/test_torch_envelope_path.py -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import attitude as ref
from benchmark.reference import attitude_envelope as env
from benchmark.reference import dp
from ocdp_tpu_torch import io
from ocdp_tpu_torch.models import attitude

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = json.loads((ROOT / "benchmark" / "configs"
                     / "attitude6d-ref.json").read_text())["params"]
SMALL = dict(n_mesh_w=5, n_mesh_q=4, T_final=0.05)      # 9 sweeps
SEGMENT = 4


def _params(seed: int) -> dict:
    """The full 6-D configuration at the small size, its cost weights
    each within +-25% of the configuration's, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    p = dict(PARAMS, **SMALL)
    for k in ("Qw", "Qq", "R"):
        p[k] = [float(x * rng.uniform(0.75, 1.25)) for x in p[k]]
    return p


def _config(p: dict) -> attitude.AttitudeConfig:
    names = {f for f in attitude.AttitudeConfig.__dataclass_fields__}
    return attitude.AttitudeConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in p.items() if k in names})


def _port(p: dict, path, tol=1e-6):
    return attitude.solve_full(
        _config(p), device="cpu", lane_mode="recompute", carry_padded=True,
        segment_size=SEGMENT, tol=tol, tol_mode="rel",
        checkpoint_path=str(path))


def _reference(p: dict, tol=1e-6, block_rows=None):
    prob = env.problem(p, "cpu", block_rows=block_rows)
    return prob, env.solve(prob, _config(p).n_stage - 1,
                           check_every=SEGMENT, tol=tol, tol_mode="rel",
                           block_rows=block_rows)


@pytest.mark.parametrize("seed", [3, 2147483917])
def test_the_envelope_path_matches_the_blocked_reference(seed, tmp_path):
    p = _params(seed)
    sol = _port(p, tmp_path / "ck.npz")
    assert sol.is_flat and sol.result.num_sweeps == 9
    assert not sol.result.converged
    prob, want = _reference(p, block_rows=7)
    assert want.sweeps == 9
    v, a = sol.result.values, sol.result.argmin.long()
    scale = float(want.values.double().abs().median())
    assert float((v.double() - want.values.double()).abs().max()) \
        < 1e-5 * scale
    gap = 0.0
    for r0, r1, q, q_min in env.last_sweep(prob, want, block_rows=7):
        got = q.gather(1, a[r0:r1, None])[:, 0]
        gap = max(gap, float((got - q_min).max()))
    assert gap < 1e-6 * scale


@pytest.mark.parametrize("block_rows", [7, 64])
def test_the_blocked_reference_agrees_with_the_unblocked_one(block_rows):
    p = _params(5)
    full = dp.solve(ref.problem(p, "cpu"), 9)
    prob, sol = _reference(p, tol=None, block_rows=block_rows)
    assert sol.sweeps == full.sweeps[0] == 9
    torch.testing.assert_close(sol.values, full.values[0], rtol=1e-6,
                               atol=0.0)
    assert torch.equal(sol.argmin.long(), full.argmin[0])
    blocks = list(env.last_sweep(prob, sol, block_rows=block_rows))
    assert [b[0] for b in blocks] == list(range(0, 125, block_rows))
    torch.testing.assert_close(torch.cat([b[2] for b in blocks]),
                               full.q[0], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(torch.cat([b[3] for b in blocks]),
                               full.q_min[0], rtol=1e-6, atol=0.0)


def test_the_last_checkpoint_is_the_returned_table(tmp_path):
    path = tmp_path / "ck.npz"
    sol = _port(_params(11), path)
    ck = io.load_values(str(path))
    assert ck.sweep_index == sol.result.num_sweeps == 9
    assert ck.values.shape == sol.result.values.shape == (125, 64)
    assert torch.equal(ck.values.view(torch.int32),
                       sol.result.values.view(torch.int32))
    # the stop rule's checksum of the second check, after sweep 6
    assert ck.prev_f is not None and ck.prev_f > 0.0
    assert [a.shape for a in ck.axes] == [(5,)] * 3 + [(4,)] * 3


def test_a_stop_at_the_second_check_is_taken_by_both(tmp_path):
    """``rel`` at 0.99 cannot stop at the first check (its sum against 0
    moves by all of itself) and stops at the second (the sum grows by less
    than itself): 6 sweeps in the port and in the reference."""
    p = _params(13)
    sol = _port(p, tmp_path / "ck.npz", tol=0.99)
    _, want = _reference(p, tol=0.99, block_rows=16)
    assert sol.result.converged
    assert sol.result.num_sweeps == want.sweeps == 6
    v = sol.result.values.double()
    assert float((v - want.values.double()).abs().max()) \
        < 1e-5 * float(want.values.double().abs().median())
