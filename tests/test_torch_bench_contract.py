"""The port's bench (``ocdp_tpu_torch/bench.py``): its printed line's keys,
its numpy baseline, every family run small on the CPU (the plain versions
stand in for the kernels there, so each counts no launch), and its two
refusals: no card, and a family that raises."""

import ast
import inspect
import json
from pathlib import Path

import pytest
import torch

from ocdp_tpu_torch import _build
from ocdp_tpu_torch import bench as tbench
from ocdp_tpu_torch.models import attitude, kirk, pos_att, position

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "workload", "wall_s",
             "baseline_evals_per_s", "families", "device", "build_s"}


def _dict_keys(src: str) -> set:
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
    return keys


def test_bench_json_contract_keys():
    # static check of the printed dict's keys without a card
    assert LINE_KEYS <= _dict_keys(inspect.getsource(tbench.main))


def test_families_are_the_root_bench_families():
    """The same eight names as the root ``bench.py`` (read, not imported)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    runners = next(n.value for n in ast.walk(main)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "runners")
    names = [k.value for k in runners.keys]
    assert list(tbench.FAMILIES) == names
    assert list(tbench.RUNNERS) == names


def test_bench_baseline_helper_runs():
    cfg = kirk.KirkConfig(N=6, dx=12, du=10)
    assert tbench.numpy_baseline_stage_seconds(cfg, n_trials=1) > 0


SMALL_POS_ATT = dict(n_mesh_x=6, n_mesh_v=6, n_mesh_t=5, n_mesh_w=5,
                     check_every=10)
SMALL = {
    "kirk": kirk.KirkConfig(N=6, dx=12, du=10),
    "attitude_axis": attitude.AttitudeConfig(n_mesh_w=40, n_mesh_t=30,
                                             T_final=0.1),
    "position": position.PositionConfig(n_mesh_x=20, n_mesh_v=20,
                                        T_final=0.1),
    "pos_att_channel": pos_att.PosAttConfig(T_final=0.5, **SMALL_POS_ATT),
    "pos_att_serving": pos_att.PosAttConfig(T_final=0.05, **SMALL_POS_ATT),
    "attitude_6d": attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4),
    "attitude_6d_converged": attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4,
                                                     T_final=0.25),
    "pos_att_highres": pos_att.PosAttConfig(T_final=0.05, **SMALL_POS_ATT),
}
FAMILY_KEYS = {
    "kirk": {"evals_per_s", "wall_s", "compile_s", "impl", "alternatives",
             "launches", "workload"},
    "attitude_axis": {"evals_per_s", "wall_s", "compile_s", "impl",
                      "alternatives", "launches", "workload"},
    "position": {"evals_per_s", "wall_s", "compile_s", "impl", "launches",
                 "workload"},
    "pos_att_channel": {"evals_per_s", "wall_s", "compile_s", "sweeps",
                        "converged", "rel_stop", "impl", "launches",
                        "workload"},
    "pos_att_serving": {"solve_all_channels_s", "solve_all_channels_warm_s",
                        "rollout_rk4_cold_s", "rollout_rk4_warm_s",
                        "realtime_factor", "batch", "batch_warm_s",
                        "batch_flight_s_per_s", "impl", "launches",
                        "workload"},
    "attitude_6d": {"evals_per_s", "wall_s", "compile_s", "sweeps", "impl",
                    "launches", "workload"},
    "attitude_6d_converged": {"evals_per_s", "wall_s", "compile_s", "sweeps",
                              "converged", "impl", "launches", "workload"},
    "pos_att_highres": {"evals_per_s", "wall_s", "compile_s", "sweeps",
                        "converged", "solve_all_channels_s",
                        "receding_horizon_cold_s", "receding_horizon_warm_s",
                        "receding_horizon_rk4_cold_s",
                        "receding_horizon_rk4_warm_s", "batch",
                        "batch_warm_s", "batch_flight_s_per_s",
                        "final_x_error_m", "impl", "launches", "workload"},
}


@pytest.mark.parametrize("name", list(SMALL))
def test_family_runs_small_on_the_cpu(name):
    out = tbench.RUNNERS[name]("cpu", SMALL[name])
    assert set(out) == FAMILY_KEYS[name]
    json.dumps(out)
    assert out["launches"] == 0 and out["impl"].count("plain (cpu)") == 1
    rate = out.get("evals_per_s", out.get("batch_flight_s_per_s"))
    assert rate > 0
    if "sweeps" in out:
        assert out["sweeps"] > 0


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        tbench.main()


def test_main_exits_nonzero_after_printing_a_failed_family(monkeypatch,
                                                           capsys):
    def broken(device):
        raise ValueError("broken family")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(tbench, "card_description", lambda: "card, 1 W")
    monkeypatch.setitem(tbench.RUNNERS, "position", broken)
    monkeypatch.setenv("BENCH_FAMILIES", "position")
    with pytest.raises(SystemExit) as exc:
        tbench.main()
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert LINE_KEYS <= set(line)
    assert line["families"] == {"position":
                                {"error": "ValueError: broken family"}}
    assert line["device"] == "card, 1 W" and line["value"] == 0.0


def test_unknown_family_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("BENCH_FAMILIES", "kirk,nope")
    with pytest.raises(SystemExit, match="nope"):
        tbench.main()
