"""The port's CLI (``python -m ocdp_tpu_torch``), run in this process on
``--device cpu``.

Each printed number equals the port's own in-process call exactly, and the
JAX package's model call for the same command within a stated tolerance:
value sums to rtol 1e-6 (f32 rounding of a sum of up to 1.2e5 cells;
measured: equal), the Kirk rollout's final state to atol 1e-6 (measured
3e-8). The JAX calls run in this process, not through the JAX CLI. The
attitude-full checkpoint cases hold a resumed solve to the straight one
bitwise, with the stop rule's last checksum (``prev_f``) carried.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu.models import position as jposition
from ocdp_tpu_torch import engine as tengine
from ocdp_tpu_torch import io as tio
from ocdp_tpu_torch.__main__ import main
from ocdp_tpu_torch.models import attitude, kirk, position

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SUM_RTOL = 1e-6
X_ATOL = 1e-6
SMALL_6D = ["--n-mesh-w", "5", "--n-mesh-q", "4", "--segment-size", "2",
            "--device", "cpu", "--quiet"]


def _run(capsys, *argv) -> dict:
    main(list(argv))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_solve_kirk_matches_port_and_jax(capsys):
    out = _run(capsys, "solve", "kirk", "--sweeps", "3", "--device", "cpu",
               "--quiet")
    cfg = dataclasses.replace(kirk.KirkConfig(), N=4)
    want = kirk.solve(cfg, device="cpu").result.values.numpy().sum()
    assert out["values_sum"] == float(want)
    jcfg = dataclasses.replace(jkirk.KirkConfig(), N=4)
    jsum = np.asarray(jkirk.solve(jcfg, impl="gather",
                                  store_policies=False).result.values).sum()
    np.testing.assert_allclose(out["values_sum"], float(jsum), rtol=SUM_RTOL)


def test_solve_position_matches_port_and_jax(capsys):
    out = _run(capsys, "solve", "position", "--sweeps", "3", "--device",
               "cpu", "--quiet")
    want = position.solve(position.PositionConfig(), num_sweeps=3,
                          device="cpu").result.values.numpy().sum()
    assert out["values_sum"] == float(want)
    jsum = np.asarray(jposition.solve(jposition.PositionConfig(),
                                      num_sweeps=3).result.values).sum()
    np.testing.assert_allclose(out["values_sum"], float(jsum), rtol=SUM_RTOL)


def test_rollout_kirk_matches_port_and_jax(capsys):
    out = _run(capsys, "rollout", "kirk", "--device", "cpu")
    sol = kirk.solve(kirk.KirkConfig.golden(), device="cpu")
    X, _ = kirk.optimal_path(sol, (2.0, 1.0))
    assert out["x_final"] == X[-1].numpy().tolist()
    jsol = jkirk.solve(jkirk.KirkConfig.golden(), impl="gather")
    jX, _ = jkirk.optimal_path(jsol, (2.0, 1.0))
    np.testing.assert_allclose(out["x_final"], np.asarray(jX)[-1],
                               atol=X_ATOL)


def test_unknown_impl_for_the_problem_raises(capsys):
    with pytest.raises(ValueError, match="unknown impl 'rowband'"):
        main(["solve", "kirk", "--sweeps", "1", "--impl", "rowband",
              "--device", "cpu", "--quiet"])


def test_resume_without_checkpoint_exits_nonzero():
    with pytest.raises(SystemExit) as exc:
        main(["solve", "attitude-full", "--resume", *SMALL_6D])
    assert isinstance(exc.value.code, str)          # exit status 1
    assert "--checkpoint" in exc.value.code


def test_segment_flags_rejected_outside_attitude_full():
    with pytest.raises(SystemExit, match="attitude-full"):
        main(["solve", "kirk", "--checkpoint", "x.npz", "--device", "cpu"])


def test_resume_after_first_segment_equals_straight_run(tmp_path, capsys):
    ck, straight = tmp_path / "ck.npz", tmp_path / "straight.npz"
    first = _run(capsys, "solve", "attitude-full", "--sweeps", "2",
                 "--checkpoint", str(ck), *SMALL_6D)
    assert first["sweep_index"] == 2 and tio.load_values(ck).sweep_index == 2
    resumed = _run(capsys, "solve", "attitude-full", "--sweeps", "4",
                   "--checkpoint", str(ck), "--resume", *SMALL_6D)
    whole = _run(capsys, "solve", "attitude-full", "--sweeps", "4",
                 "--checkpoint", str(straight), *SMALL_6D)
    assert (resumed["sweeps"], resumed["sweep_index"]) == (2, 4)
    assert (whole["sweeps"], whole["sweep_index"]) == (4, 4)
    assert resumed["values_sum"] == whole["values_sum"]
    got, want = tio.load_values(ck), tio.load_values(straight)
    assert got.sweep_index == want.sweep_index == 4
    assert torch.equal(got.values, want.values)


def test_resume_carries_prev_f(tmp_path, capsys, monkeypatch):
    """A run with the stop rule killed after its first checkpoint (sweep 2,
    a check sweep) and resumed stops where the straight run stops: at the
    check of sweep 4, which compares against the checkpoint's ``prev_f``.
    Without it the check compares against 0 and the solve runs on to 5."""
    ck, straight = tmp_path / "ck.npz", tmp_path / "straight.npz"
    stop = ["--sweeps", "5", "--tol", "0.9", "--tol-mode", "rel"]
    whole = _run(capsys, "solve", "attitude-full", *stop, "--checkpoint",
                 str(straight), *SMALL_6D)
    assert (whole["sweep_index"], whole["converged"]) == (4, True)

    save = tengine.save_values

    def save_then_die(*args, **kw):
        save(*args, **kw)
        raise KeyboardInterrupt("killed after the first checkpoint")

    monkeypatch.setattr(tengine, "save_values", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        main(["solve", "attitude-full", *stop, "--checkpoint", str(ck),
              *SMALL_6D])
    monkeypatch.undo()
    killed = tio.load_values(ck)
    assert killed.sweep_index == 2 and killed.prev_f is not None

    resumed = _run(capsys, "solve", "attitude-full", *stop, "--checkpoint",
                   str(ck), "--resume", *SMALL_6D)
    assert (resumed["sweep_index"], resumed["converged"]) == (4, True)
    assert resumed["values_sum"] == whole["values_sum"]
    assert torch.equal(tio.load_values(ck).values,
                       tio.load_values(straight).values)

    # the same resume with prev_f dropped misses the stop
    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    dropped = attitude.solve_full(
        cfg, device="cpu", num_sweeps=5, segment_size=2, tol=0.9,
        tol_mode="rel", init_values=killed.values, start_sweep=2,
        prev_f=None)
    assert not dropped.result.converged and dropped.result.num_sweeps == 3


def test_rollout_plot_writes_the_figure(tmp_path, capsys):
    _run(capsys, "rollout", "kirk", "--device", "cpu", "--plot",
         str(tmp_path))
    assert (tmp_path / "kirk_rollout.png").stat().st_size > 0


def test_plot_without_matplotlib_fails_clearly(tmp_path):
    """As on a machine without matplotlib: ``--plot`` raises an
    ImportError that names it, before any solve."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "from ocdp_tpu_torch.__main__ import main; "
            f"main(['rollout', 'kirk', '--device', 'cpu', '--plot', "
            f"{str(tmp_path)!r}])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "ImportError: ocdp_tpu_torch.viz needs matplotlib" in proc.stderr
    assert proc.stdout == ""
