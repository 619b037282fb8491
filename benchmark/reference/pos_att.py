"""The pos-att channels as row/lane problems, from the configuration alone.

Per channel a 4-D state (x, v, theta, omega) on ``n_mesh_x x n_mesh_v x
n_mesh_t x n_mesh_w`` cells, four on/off thrusters whose opposing-pair
firings are pruned (9 combinations, 6 with the channel's first thruster
failed), Euler steps of ``h`` and the quadratic stage cost
(Solver_pos_att.m:100-156, 244-265, 784-802, 886-918). Rows are (v,
omega), whose next states depend on the action; lanes (x, theta), whose
next states ``x + h v`` and ``theta + h omega`` depend on the row and the
lane. The channels x, y, z and x_failure (:217-240) run side by side.
"""

from __future__ import annotations

import numpy as np
import torch

from .dp import RowLaneProblem, corners, locate

__all__ = ["CHANNELS", "channel_axes", "channel_forces", "located", "problem",
           "natural_to_rowlane", "rowlane_to_natural"]

# (name, body axis, first thruster failed)
CHANNELS = (("x", 0, False), ("y", 1, False), ("z", 2, False),
            ("x_failure", 0, True))


def sym_axis(a: float, b: float, n: int) -> np.ndarray:
    """``n`` points from ``a`` to ``b`` through 0, the left half one point
    longer for even ``n`` (Solver_pos_att.m:906-918), float32."""
    half = int(np.ceil(n / 2))
    left = half + 1 if n % 2 == 0 else half
    return np.concatenate([np.linspace(a, 0.0, left),
                           np.linspace(0.0, b, half)[1:]]).astype(np.float32)


def channel_axes(cfg: dict, axis: int):
    """(x, v, theta, omega) axes of a channel, float32 numpy."""
    t_lo, t_hi = cfg["theta_ranges_deg"][axis]
    return (sym_axis(cfg["x_min"], cfg["x_max"], cfg["n_mesh_x"]),
            sym_axis(cfg["v_min"], cfg["v_max"], cfg["n_mesh_v"]),
            sym_axis(np.deg2rad(t_lo), np.deg2rad(t_hi), cfg["n_mesh_t"]),
            sym_axis(np.deg2rad(cfg["w_min_deg"]), np.deg2rad(cfg["w_max_deg"]),
                     cfg["n_mesh_w"]))


def channel_forces(cfg: dict, failure: bool) -> np.ndarray:
    """(n, 4) thruster forces (f0, f1, f6, f7), f0 varying fastest, without
    the combinations that fire an opposing pair (:886-904)."""
    f = cfg["thruster_force"]
    sets = ([0.0] if failure else [0.0, f], [0.0, f], [0.0, -f], [0.0, -f])
    rows = []
    for f7 in sets[3]:
        for f6 in sets[2]:
            for f1 in sets[1]:
                for f0 in sets[0]:
                    if (f0 > 0 and f6 < 0) or (f1 > 0 and f7 < 0):
                        continue
                    rows.append((f0, f1, f6, f7))
    return np.asarray(rows, np.float32)


def channel_inertia(cfg: dict, axis: int) -> float:
    """x turns about the body y axis (J2), y about z (J3), z about x (J1)."""
    d = cfg["inertia_diag"]
    return (d[1], d[2], d[0])[axis]


def located(cfg: dict, axis: int, failure: bool, device):
    """A channel's next states located on its axes (float32): per row axis
    (v, omega) ``(n_k, A)`` and per lane axis, x over ``(n_v, n_x)`` and
    theta over ``(n_omega, n_theta)``, each ``(lo, frac)``; and the axes
    and forces."""
    h = cfg["h"]
    s_x, s_v, s_t, s_w = (torch.as_tensor(a, device=device)
                          for a in channel_axes(cfg, axis))
    f = torch.as_tensor(channel_forces(cfg, failure), device=device)
    fsum = f.sum(1)
    fmom = f[:, 0] - f[:, 1] + f[:, 2] - f[:, 3]
    v_next = s_v[:, None] + h * fsum[None, :] / cfg["mass"]
    w_next = s_w[:, None] + h * fmom[None, :] * cfg["moment_arm"] \
        / channel_inertia(cfg, axis)
    rows = (locate(s_v, v_next), locate(s_w, w_next))
    lanes = (locate(s_x, s_x[None, :] + h * s_v[:, None]),
             locate(s_t, s_t[None, :] + h * s_w[:, None]))
    return rows, lanes, (s_x, s_v, s_t, s_w), f


def problem(cfg: dict, device, n_actions: int = 9) -> RowLaneProblem:
    """The four channels, actions padded to ``n_actions`` (a missing action
    costs ``inf``). Next states and costs in float32."""
    parts = []
    for _, axis, failure in CHANNELS:
        ((lo_v, fr_v), (lo_w, fr_w)), ((lo_x, fr_x), (lo_t, fr_t)), \
            (s_x, s_v, s_t, s_w), f = located(cfg, axis, failure, device)
        n_a = f.shape[0]
        nv, nww, nx, nt = (a.numel() for a in (s_v, s_w, s_x, s_t))
        r_idx, r_w = corners(
            (lo_v[:, None, :], lo_w[None, :, :]),
            (fr_v[:, None, :], fr_w[None, :, :]), (nv, nww))
        r_idx = r_idx.reshape(nv * nww, n_a, 4)
        r_w = r_w.reshape(nv * nww, n_a, 4)
        # rows (v, w), lanes (x, t)
        l_idx, l_w = corners(
            (lo_x[:, None, :, None], lo_t[None, :, None, :]),
            (fr_x[:, None, :, None], fr_t[None, :, None, :]), (nx, nt))
        l_idx = l_idx.reshape(nv * nww, nx * nt, 4)
        l_w = l_w.reshape(nv * nww, nx * nt, 4)
        c_row = (cfg["Qv"] * s_v[:, None] ** 2
                 + cfg["Qw"] * s_w[None, :] ** 2).reshape(-1)
        c_lane = (cfg["Qx"] * s_x[:, None] ** 2
                  + cfg["Qt"] * s_t[None, :] ** 2).reshape(-1)
        c_act = cfg["R"] * (f ** 2).sum(1)
        pad = n_actions - n_a
        if pad:
            own = torch.arange(nv * nww, device=device)[:, None, None]
            r_idx = torch.cat([r_idx, own.expand(-1, pad, 4)], 1)
            r_w = torch.cat([r_w, torch.zeros_like(r_w[:, :pad])], 1)
            c_act = torch.cat([c_act, torch.full((pad,), float("inf"),
                                                  device=device)])
        parts.append((r_idx, r_w, l_idx, l_w, c_row, c_lane, c_act))
    return RowLaneProblem(*(torch.stack(t) for t in zip(*parts)))


def natural_to_rowlane(t: torch.Tensor) -> torch.Tensor:
    """A channel table in the state order (x, v, theta, omega) as the
    ``(v omega, x theta)`` rows and lanes."""
    nx, nv, nt, nw = t.shape
    return t.permute(1, 3, 0, 2).reshape(nv * nw, nx * nt)


def rowlane_to_natural(t: torch.Tensor, shape) -> torch.Tensor:
    nx, nv, nt, nw = shape
    return t.reshape(nv, nw, nx, nt).permute(2, 0, 3, 1)
