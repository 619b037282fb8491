"""Visualization: policy surfaces, trajectories, dashboards (counterpart of
``ocdp_tpu/viz.py``).

Host-side matplotlib equivalents of the reference's plotting:
* ``plot_policy_surface`` / ``plot_policy_stages`` — ``plot_u_star``
  (test/Dynamic_Solver.m:240-261), the per-stage policy surface;
  ``animate_policy_surface`` its animation as a GIF.
* ``plot_rollout`` — the state/control panels every ``get_optimal_path``
  draws (Dynamic_Solver.m:157-167; Solver_position.m:228-256;
  Solver_attitude.m:789-832).
* ``plot_thruster_dashboard`` — the 12-panel thruster-firing dashboard
  (Solver_pos_att.m:509-584).
* ``plot_forces_moments`` — the forces/moments panel (Solver_pos_att.m:586-626).

Every function takes tensors (on any device) or arrays; tensors are moved
to the host first. All return the matplotlib Figure (the animation its
path); pass ``path=`` to save. Uses the Agg backend, safe headless.
matplotlib is needed only here: nothing else in the package imports this
module, and importing it without matplotlib raises an ``ImportError`` that
says so.
"""

from __future__ import annotations

try:
    import matplotlib
except ImportError as e:      # the package runs without it; plotting cannot
    raise ImportError(
        "ocdp_tpu_torch.viz needs matplotlib, which is not installed in this "
        "environment; install it to plot (or drop --plot)") from e

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

__all__ = [
    "plot_policy_surface",
    "plot_policy_stages",
    "animate_policy_surface",
    "plot_rollout",
    "plot_thruster_dashboard",
    "plot_forces_moments",
]


def _host(x):
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save(fig, path):
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def _mesh(axes):
    return np.meshgrid(_host(axes[0]), _host(axes[1]), indexing="ij")


def plot_policy_surface(u_table, axes, *, stage=None, labels=("x1", "x2"),
                        path=None):
    """One 2-D policy table as a surface (plot_u_star, :246-259)."""
    X, Y = _mesh(axes)
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(X, Y, _host(u_table), cmap="viridis",
                    linewidth=0, antialiased=False)
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])
    ax.set_zlabel("u*")
    if stage is not None:
        ax.set_title(f"optimal control table, stage {stage}")
    return _save(fig, path)


def plot_policy_stages(u_star, axes, *, stages=None, labels=("x1", "x2"),
                       path=None):
    """Grid of policy surfaces over stages (the reference animates; we tile)."""
    u_star = _host(u_star)
    if stages is None:
        n = u_star.shape[0]
        stages = np.unique(np.linspace(0, n - 1, min(6, n)).astype(int))
    cols = min(3, len(stages))
    rows = -(-len(stages) // cols)
    X, Y = _mesh(axes)
    fig = plt.figure(figsize=(4.5 * cols, 3.5 * rows))
    for i, k in enumerate(stages):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        ax.plot_surface(X, Y, u_star[k], cmap="viridis", linewidth=0)
        ax.set_title(f"stage {k}")
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
    return _save(fig, path)


def animate_policy_surface(u_star, axes, path, *, stages=None,
                           labels=("x1", "x2"), fps=5):
    """Animated GIF of the per-stage policy surface — the reference's
    ``plot_u_star`` pause-loop (test/Dynamic_Solver.m:240-261).

    ``u_star``: (n_stages, n1, n2) stack; ``path`` must end in ``.gif``.
    """
    from matplotlib.animation import FuncAnimation, PillowWriter

    u = _host(u_star)
    if stages is None:
        stages = range(u.shape[0])
    stages = list(stages)
    X, Y = _mesh(axes)
    vmin, vmax = float(u[stages].min()), float(u[stages].max())
    if vmax <= vmin:
        vmin, vmax = vmin - 0.5, vmax + 0.5
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")

    def draw(i):
        ax.clear()
        k = stages[i]
        ax.plot_surface(X, Y, u[k], cmap="viridis", linewidth=0,
                        antialiased=False)
        ax.set_zlim(vmin, vmax)
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
        ax.set_zlabel("u*")
        ax.set_title(f"optimal control table, stage {k}")
        return ()

    anim = FuncAnimation(fig, draw, frames=len(stages), blit=False)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_rollout(T, X, U=None, *, state_labels=None, control_labels=None,
                 path=None):
    """States (and controls) vs time, the universal rollout panel."""
    T = _host(T)
    X = _host(X)
    n_panels = 1 + (U is not None)
    fig, axs = plt.subplots(n_panels, 1, figsize=(8, 3.2 * n_panels),
                            squeeze=False)
    ax = axs[0, 0]
    for i in range(X.shape[1]):
        lbl = state_labels[i] if state_labels else f"x{i + 1}"
        ax.plot(T[:X.shape[0]], X[:, i], label=lbl)
    ax.legend(loc="best", fontsize=8)
    ax.grid(True)
    ax.set_ylabel("states")
    if U is not None:
        U = _host(U)
        ax = axs[1, 0]
        for i in range(U.shape[1] if U.ndim > 1 else 1):
            u = U[:, i] if U.ndim > 1 else U
            lbl = control_labels[i] if control_labels else f"u{i + 1}"
            ax.step(T[:len(u)], u, where="post", label=lbl)
        ax.legend(loc="best", fontsize=8)
        ax.grid(True)
        ax.set_ylabel("controls")
    axs[-1, 0].set_xlabel("time (s)")
    return _save(fig, path)


def plot_thruster_dashboard(T, F_th, *, path=None):
    """12-panel on/off firing dashboard (Solver_pos_att.m:509-584)."""
    T = _host(T)
    F = _host(F_th)
    fig, axs = plt.subplots(6, 2, figsize=(10, 12), sharex=True)
    for i in range(12):
        ax = axs[i % 6, i // 6]
        ax.step(T[:F.shape[0]], F[:, i], where="post", linewidth=0.8)
        ax.set_ylim(-0.15, 0.15)
        ax.set_ylabel(f"Thr {i}", fontsize=8)
        ax.grid(True, alpha=0.4)
    axs[-1, 0].set_xlabel("time (s)")
    axs[-1, 1].set_xlabel("time (s)")
    fig.suptitle("thruster firings (N)")
    return _save(fig, path)


def plot_forces_moments(T, FM, *, path=None):
    """Accelerations + moments panel (Solver_pos_att.m:586-626)."""
    T = _host(T)
    FM = _host(FM)
    fig, axs = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for i, lbl in enumerate(("a_x", "a_y", "a_z")):
        axs[0].plot(T[:FM.shape[0]], FM[:, i], label=lbl)
    axs[0].legend()
    axs[0].grid(True)
    axs[0].set_ylabel("accel (RSW)")
    for i, lbl in enumerate(("M_x", "M_y", "M_z")):
        axs[1].plot(T[:FM.shape[0]], FM[:, 3 + i], label=lbl)
    axs[1].legend()
    axs[1].grid(True)
    axs[1].set_ylabel("moments (N m)")
    axs[1].set_xlabel("time (s)")
    return _save(fig, path)
