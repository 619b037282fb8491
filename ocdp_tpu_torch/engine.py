"""Backward value-iteration engines (counterpart of ``ocdp_tpu/engine.py``).

Two engines mirror the reference's two loop shapes, a third runs the
finite one in host-visible segments, and a fourth runs the converged one
over a batch of channels in lockstep:

* :func:`value_iteration_finite` — fixed number of backward sweeps with an
  optional per-sweep policy store; the Kirk finite-horizon loop
  (test/Dynamic_Solver.m:86-102).
* :func:`value_iteration_converged` — value iteration with the pos-att
  early-stopping rule: every ``check_every`` sweeps compare the summed value
  table against the previous checkpoint and stop per
  :func:`convergence_stop` (pos-att/Solver_pos_att.m:268-286).
* :func:`value_iteration_segmented` — the finite engine in segments, with
  host-streamed policies, a checkpoint per segment, resume, and the
  converged engine's stop rule at its own check sweeps.
* :func:`value_iteration_converged_batch` — the converged engine over the
  channels of a batched backup (:class:`~ocdp_tpu_torch.ops.rowlane.
  RowLaneBatch`), one launch a sweep, each channel with its own checks and
  stop; each channel's result equals the converged engine's alone.

Each is a Python loop over sweeps; the device work of a sweep is the
backup's. Policies go into one preallocated tensor. The finite loop never
waits for the device unless a per-sweep callback is given; the converged
loops read one checksum per check.

CUDA graphs: a backup that declares itself ``graph_safe`` (it sweeps into
the caller's buffers with :meth:`sweep_into`, allocating nothing and
setting no function attribute) runs in the finite engine, when no policies,
probes or per-sweep callback are asked for, as ``GRAPH_SWEEPS`` sweeps over
ping-pong buffers captured once into a :class:`torch.cuda.CUDAGraph` and
replayed; the remainder runs eagerly. The batched converged engine replays
the ``check_every`` sweeps between two checks the same way. On the CPU the
same schedule runs eagerly (the graphs' eager twin). A capture or replay
error raises; nothing falls back to eager launches. Each replay adds the
launches it captured to the kernel's launch and channel-sweep counters.

A backup that lists the policy dtype in its ``argmin_dtypes`` (the fused
2-D backup's affine mode) runs the finite engine's eager loop through
:meth:`sweep_into` over ping-pong tables, its argmin written straight into
the sweep's policy slot (or one int32 buffer): no allocation or copy a
sweep.

Stage-loop semantics: sweep ``j=0`` is the backup from the terminal cost
(the reference's ``k = 1`` / ``k_s = N-1``), so for a finite-horizon rollout
at forward stage ``k`` (0-based) the policy to use is ``policies[N-2-k]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .io import CheckpointWriter, save_values
from .ops.backup import bellman_backup
from .ops.interp import InterpPlan
from .profiling import span

__all__ = [
    "GRAPH_SWEEPS",
    "SolveResult",
    "SweepGraph",
    "converged_schedule",
    "finite_schedule",
    "value_iteration_finite",
    "value_iteration_converged",
    "value_iteration_converged_batch",
    "value_iteration_segmented",
    "policy_dtype_for",
    "convergence_stop",
]

# sweeps a finite-engine CUDA graph replays
GRAPH_SWEEPS = 100


def convergence_stop(err_f: float, fsum: float, tol: float,
                     tol_mode: str = "abs") -> bool:
    """The early-stop predicate evaluated at each periodic checkpoint.

    * ``'abs'`` — ``|Δ Σ V| < tol``: the reference's rule verbatim
      (pos-att/Solver_pos_att.m:280).
    * ``'rel'`` — ``|Δ Σ V| < tol * max(|Σ V|, 1)``: the scale-free stop,
      beyond reference parity.
    """
    if tol_mode == "abs":
        return abs(err_f) < tol
    if tol_mode == "rel":
        return abs(err_f) < tol * max(abs(fsum), 1.0)
    raise ValueError(f"unknown tol_mode {tol_mode!r}; use 'abs' or 'rel'")


class SolveResult(NamedTuple):
    values: torch.Tensor           # final value table V, state-grid shape
    # flat-action argmin of the LAST sweep: int32, or the narrow policy
    # dtype with narrow_argmin_result=True
    argmin: torch.Tensor
    policies: Optional[torch.Tensor]  # (num_sweeps, *state_shape) or None
    num_sweeps: int                # sweeps performed
    converged: bool                # always False for the finite engine
    probes: Optional[torch.Tensor] = None  # (num_sweeps, *window) or None
    # converged-engine check log, (n_checks, 3) float32: [k_s, errorF,
    # errorU] per check (Solver_pos_att.m:272-279); rows past the stop are 0
    checks: Optional[torch.Tensor] = None
    # row-sharded 6-D engines with an action axis: whether the action
    # groups ran the factorized (digit-slice) phase; None elsewhere
    digit_path: Optional[bool] = None


def policy_dtype_for(n_actions: int) -> torch.dtype:
    """Smallest integer dtype that can index ``n_actions`` actions.

    The reference plans uint8 argmin storage for the same reason
    (Solver_attitude.m:189-191).
    """
    if n_actions <= torch.iinfo(torch.uint8).max + 1:
        return torch.uint8
    if n_actions <= torch.iinfo(torch.int16).max + 1:
        return torch.int16
    return torch.int32


def _policy_dtype(policy_dtype, n_actions: int) -> torch.dtype:
    """``policy_dtype``, or :func:`policy_dtype_for` when it is None; raises
    for a dtype too narrow for the actions."""
    if policy_dtype is None:
        return policy_dtype_for(n_actions)
    if torch.iinfo(policy_dtype).max < n_actions - 1:
        raise ValueError(
            f"policy_dtype {policy_dtype} cannot hold {n_actions} actions")
    return policy_dtype


def _initial_values(plan: InterpPlan, init_values) -> torch.Tensor:
    if init_values is None:
        return torch.zeros(plan.grid_shape, dtype=torch.float32,
                           device=plan.device)
    return torch.as_tensor(init_values, dtype=torch.float32,
                           device=plan.device).contiguous()


def _sync_for_callback(values: torch.Tensor) -> None:
    # a host callback that times sweeps must see the sweep finished, not
    # merely enqueued
    if values.is_cuda:
        torch.cuda.synchronize(values.device)


def ping_pong(step, cur: torch.Tensor, nxt: torch.Tensor, n: int) -> None:
    """``n`` sweeps ``step(src, dst)`` alternating between ``cur`` and
    ``nxt``, starting from ``cur``; the result ends in ``cur`` (an odd
    ``n`` ends with one copy back)."""
    src, dst = cur, nxt
    for _ in range(n):
        step(src, dst)
        src, dst = dst, src
    if n % 2:
        cur.copy_(nxt)


class SweepGraph:
    """``n`` sweeps of :func:`ping_pong` over fixed buffers, captured once
    into a CUDA graph and replayed.

    ``launchers``: the kernels' wrappers whose ``launches`` and
    ``channel_sweeps`` counters the capture moves;
    the capture's counts are taken back and each :meth:`replay` adds them,
    so the counters count the launches that ran. Call only after the
    kernels are built and configured (the backups' ``prepare``): the
    capture must set no function attribute. Any capture or replay error
    raises.
    """

    COUNTERS = ("launches", "channel_sweeps")

    def __init__(self, step, cur, nxt, n: int, launchers=()):
        with span("ocdp.engine.capture"):
            before = [[getattr(f, k) for k in self.COUNTERS]
                      for f in launchers]
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    ping_pong(step, cur, nxt, n)
            finally:
                after = [[getattr(f, k) for k in self.COUNTERS]
                         for f in launchers]
                for f, b in zip(launchers, before):
                    for k, v in zip(self.COUNTERS, b):
                        setattr(f, k, v)
            self.counts = [(f, [a - b for a, b in zip(aa, bb)])
                           for f, aa, bb in zip(launchers, after, before)]

    def replay(self) -> None:
        self.graph.replay()
        for f, deltas in self.counts:
            for k, d in zip(self.COUNTERS, deltas):
                setattr(f, k, getattr(f, k) + d)


def finite_schedule(num_sweeps: int, k: int = GRAPH_SWEEPS) -> list:
    """The finite graph engine's runs: ``num_sweeps // k`` runs of ``k``
    (each a graph replay on a card), then the remainder (eager)."""
    runs = [k] * (num_sweeps // k)
    return runs + [num_sweeps % k] if num_sweeps % k else runs


def _finite_graphed(plan, backup, num_sweeps, init_values,
                    narrow_argmin_result) -> SolveResult:
    """The finite engine through a graph-safe backup: ping-pong tables and
    one int32 argmin buffer allocated once, runs of ``GRAPH_SWEEPS`` sweeps
    replayed as one CUDA graph on a card (run eagerly on the CPU, the same
    schedule), the remainder eager."""
    v0 = _initial_values(plan, init_values)
    cur = v0.clone()
    nxt = torch.empty_like(cur)
    argmin = torch.zeros(plan.grid_shape, dtype=torch.int32, device=cur.device)

    def step(src, dst):
        backup.sweep_into(src, dst, argmin)

    graph = None
    for n in finite_schedule(num_sweeps, GRAPH_SWEEPS):
        if cur.is_cuda and n == GRAPH_SWEEPS:
            if graph is None:
                with span("ocdp.engine.prepare"):
                    backup.prepare()
                graph = SweepGraph(step, cur, nxt, n, (backup.launcher,))
            with span("ocdp.engine.sweeps", str(n)):
                graph.replay()
        else:
            with span("ocdp.engine.sweeps", str(n)):
                ping_pong(step, cur, nxt, n)
    with span("ocdp.engine.finish"):
        pdt = policy_dtype_for(plan.query_shape[-1])
        if narrow_argmin_result:
            argmin = argmin.to(pdt)
    return SolveResult(values=cur, argmin=argmin, policies=None,
                       num_sweeps=num_sweeps, converged=False)


def value_iteration_finite(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    *,
    init_values: Optional[torch.Tensor] = None,
    store_policies: bool = False,
    policy_dtype: Optional[torch.dtype] = None,
    backup=None,
    probe_window=None,
    narrow_argmin_result: bool = False,
    on_sweep=None,
) -> SolveResult:
    """Run exactly ``num_sweeps`` Bellman backups (finite-horizon DP).

    ``num_sweeps`` is the reference's ``N-1`` (terminal cost J_N = 0 is the
    initial table; each sweep produces the previous stage's value/policy).

    ``backup``: optional callable ``values -> BackupResult`` replacing the
    plain gather backup — e.g. a
    :class:`~ocdp_tpu_torch.ops.fused_backup2d.FusedBackup2D`.

    ``probe_window``: optional tuple of ``(start, size)`` per state dim; the
    window of V after every sweep lands in ``SolveResult.probes`` (the
    reference's ``checkstagesXJF`` probes, test/Dynamic_Solver.m:212-219).

    ``narrow_argmin_result``: return ``argmin`` in the narrow policy dtype
    (uint8 at <= 256 actions) instead of int32.

    ``on_sweep(i)``: optional host callback after each sweep (the
    reference's per-stage 'step %d - %f seconds' print). On a CUDA device
    the engine synchronizes before each call, so the callback sees the
    sweep completed; without a callback nothing synchronizes.

    A backup built with ``carry_padded=True`` (:class:`~ocdp_tpu_torch.ops.
    backup6d.Backup6D`'s carry mode, ``ocdp_tpu/engine.py:166-205``) runs,
    when no policies are stored, through :func:`_finite_carry`: two
    ``(NW, NE)`` tables and one argmin buffer in the backup's narrow dtype,
    allocated once. Flat-plan results then stay ``(NW, NE)``;
    ``probe_window`` is refused there.
    """
    if not store_policies and getattr(backup, "carry_padded", False):
        return _finite_carry(plan, backup, num_sweeps, init_values,
                             probe_window, narrow_argmin_result, on_sweep)
    if (getattr(backup, "graph_safe", False) and not store_policies
            and probe_window is None and on_sweep is None):
        return _finite_graphed(plan, backup, num_sweeps, init_values,
                               narrow_argmin_result)
    v = _initial_values(plan, init_values)
    pdt = _policy_dtype(policy_dtype, plan.query_shape[-1])
    if backup is None:
        backup = lambda v: bellman_backup(v, plan, stage_cost)  # noqa: E731

    window = None
    probes = None
    if probe_window is not None:
        window = tuple(slice(s, s + n) for s, n in probe_window)
        if any(w.start < 0 or w.stop > g
               for w, g in zip(window, plan.grid_shape)):
            raise ValueError(f"probe_window {probe_window} leaves the grid "
                             f"{plan.grid_shape}")
        probes = torch.empty((num_sweeps, *(n for _, n in probe_window)),
                             dtype=torch.float32, device=v.device)
    policies = (torch.empty((num_sweeps, *plan.grid_shape), dtype=pdt,
                            device=v.device) if store_policies else None)

    argmin = torch.zeros(plan.grid_shape, dtype=torch.int32, device=v.device)
    into = (pdt if policies is not None else torch.int32) in \
        getattr(backup, "argmin_dtypes", ())
    if into:
        v, spare = v.clone(), torch.empty_like(v)
    with span("ocdp.engine.sweeps", str(num_sweeps)):
        for i in range(num_sweeps):
            if into:
                backup.sweep_into(
                    v, spare, policies[i] if policies is not None else argmin)
                v, spare = spare, v
            else:
                v, argmin = backup(v)
                if policies is not None:
                    policies[i] = argmin
            if probes is not None:
                probes[i] = v[window]
            if on_sweep is not None:
                _sync_for_callback(v)
                on_sweep(i)
    with span("ocdp.engine.finish"):
        if into and policies is not None and num_sweeps:
            argmin = policies[num_sweeps - 1].clone()
        argmin = argmin.to(pdt if narrow_argmin_result else torch.int32)
    return SolveResult(
        values=v,
        argmin=argmin,
        policies=policies,
        num_sweeps=num_sweeps,
        converged=False,
        probes=probes,
    )


def _finite_carry(plan, backup, num_sweeps, init_values, probe_window,
                  narrow_argmin_result, on_sweep) -> SolveResult:
    """The finite engine in carry mode: each sweep writes the next table
    into the other of two buffers (ping-pong) and the argmin into one
    buffer of the backup's dtype; nothing is allocated per sweep."""
    if probe_window is not None:
        raise ValueError("probe_window is unsupported with a carry-mode "
                         "backup (the carry is the flat (NW, NE) table)")
    cur, nxt, argmin = _carry_buffers(plan, backup, init_values)
    cur, nxt = _carry_sweeps(backup, cur, nxt, argmin, num_sweeps, on_sweep)
    del nxt
    return _carry_result(plan, cur, argmin, narrow_argmin_result,
                         num_sweeps, False)


def _carry_buffers(plan, backup, init_values):
    """Carry mode's buffers, allocated once per solve: the current and the
    next ``(NW, NE)`` table (the current one a copy of ``init_values``, so
    the ping-pong never writes the caller's) and one argmin buffer in the
    backup's narrow dtype."""
    nw, ne = backup.NW, backup.NE
    dev = plan.device
    cur = torch.zeros((nw, ne), dtype=torch.float32, device=dev)
    if init_values is not None:
        cur.copy_(torch.as_tensor(init_values, dtype=torch.float32,
                                  device=dev).reshape(nw, ne))
    argmin = torch.zeros((nw, ne), dtype=backup.argmin_dtype, device=dev)
    return cur, torch.empty_like(cur), argmin


def _carry_sweeps(backup, cur, nxt, argmin, n, on_sweep=None):
    """``n`` carry-mode sweeps; returns ``(cur, nxt)`` swapped as many
    times."""
    with span("ocdp.engine.sweeps", str(n)):
        for i in range(n):
            backup.sweep_into(cur, nxt, argmin)
            cur, nxt = nxt, cur
            if on_sweep is not None:
                _sync_for_callback(cur)
                on_sweep(i)
    return cur, nxt


def _carry_view(plan, t: torch.Tensor) -> torch.Tensor:
    """A carry buffer as the plan's result table: ``(NW, NE)`` for a flat
    plan, a view in the state grid's shape otherwise."""
    if len(plan.query_shape) == plan.ndim + 1:     # not a flat plan
        return t.reshape(plan.grid_shape)
    return t


def _carry_result(plan, cur, argmin, narrow_argmin_result, num_sweeps,
                  converged) -> SolveResult:
    with span("ocdp.engine.finish"):
        if not narrow_argmin_result:
            argmin = argmin.to(torch.int32)
        values, argmin = _carry_view(plan, cur), _carry_view(plan, argmin)
    return SolveResult(values=values, argmin=argmin, policies=None,
                       num_sweeps=num_sweeps, converged=converged)


def value_iteration_converged(
    plan: InterpPlan,
    stage_cost,
    max_sweeps: int,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    init_values: Optional[torch.Tensor] = None,
    backup=None,
    on_check=None,
    narrow_argmin_result: bool = False,
) -> SolveResult:
    """Value iteration with the reference's periodic-checksum early stop.

    Mirrors pos-att/Solver_pos_att.m:268-286: iterate ``k_s`` from
    ``max_sweeps`` down to 1; whenever ``k_s % check_every == 0`` (after the
    sweep at that ``k_s``), compare ``errorF = Σ V - Σ V_prev_check`` and
    stop per :func:`convergence_stop`. Each check also records
    ``errorU = Σ argmin_ids - Σ argmin_ids_prev_check`` (the reference's
    second diagnostic, :275-278); both land in ``SolveResult.checks`` as
    rows ``[k_s, errorF, errorU]``, and ``on_check(k_s, errorF, errorU)`` is
    called per check when given. The sums are float32, and both "previous"
    sums start at 0.0.
    """
    convergence_stop(0.0, 0.0, tol, tol_mode)     # validate tol_mode early
    v = _initial_values(plan, init_values)
    if backup is None:
        backup = lambda v: bellman_backup(v, plan, stage_cost)  # noqa: E731
    pdt = (policy_dtype_for(plan.query_shape[-1]) if narrow_argmin_result
           else torch.int32)

    n_checks = max(max_sweeps // check_every, 1)
    checks = torch.zeros((n_checks, 3), dtype=torch.float32)
    argmin = torch.zeros(plan.grid_shape, dtype=torch.int32, device=v.device)
    fsum_prev = usum_prev = torch.zeros((), dtype=torch.float32)
    c_idx = num_sweeps = 0
    converged = False
    for n, k_s, is_check in converged_schedule(max_sweeps, check_every):
        with span("ocdp.engine.sweeps", str(n)):
            for _ in range(n):
                v, argmin = backup(v)
        num_sweeps += n
        if not is_check:
            continue
        with span("ocdp.engine.check"):
            fsum = v.sum(dtype=torch.float32).cpu()
            usum = argmin.sum(dtype=torch.float32).cpu()
            err_f, err_u = fsum - fsum_prev, usum - usum_prev
            converged = convergence_stop(float(err_f), float(fsum), tol,
                                         tol_mode)
            checks[c_idx] = torch.stack(
                [torch.tensor(float(k_s)), err_f, err_u])
            if on_check is not None:
                on_check(k_s, float(err_f), float(err_u))
            c_idx += 1
            fsum_prev, usum_prev = fsum, usum
        if converged:
            break
    with span("ocdp.engine.finish"):
        argmin, checks = argmin.to(pdt), checks.to(v.device)
    return SolveResult(values=v, argmin=argmin, policies=None,
                       num_sweeps=num_sweeps, converged=converged,
                       checks=checks)


def converged_schedule(max_sweeps: int, check_every: int) -> list:
    """The converged engine's runs of sweeps: ``(n, k_s, check)`` for each
    run of ``n`` sweeps whose last sweep has countdown ``k_s``, ``check``
    whether the stop rule is evaluated right after it (``k_s`` a multiple
    of ``check_every``). Pos-att's 1999 sweeps at ``check_every=50``: 39
    runs of 50, each ending at a check, then 49."""
    runs = []
    k = max_sweeps                        # the countdown of the next sweep
    while k >= 1:
        last = (k // check_every) * check_every
        if last >= 1:
            runs.append((k - last + 1, last, True))
            k = last - 1
        else:
            runs.append((k, 1, False))
            k = 0
    return runs


def value_iteration_converged_batch(
    batch,
    max_sweeps: int,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    init_values=None,
    on_check=None,
    narrow_argmin_result: bool = False,
) -> list:
    """:func:`value_iteration_converged` for every channel of ``batch`` at
    once (a :class:`~ocdp_tpu_torch.ops.rowlane.RowLaneBatch`): one launch
    a sweep over the channels still running, in the backup's own table
    layout, with ping-pong tables and an argmin buffer allocated once.

    Each channel keeps its own countdown, checks and stop: at a check its
    table and argmin are taken into the natural state order as contiguous
    tensors and summed there, as the one-channel engine sums them; a
    channel that stops leaves the batch with the values and argmin of its
    stop sweep. The runs between two checks (``check_every`` sweeps) are
    one CUDA graph a set of running channels on a card, replayed; other
    runs, and every run on the CPU, are eager launches. ``init_values``
    and ``on_check`` are per channel (sequences, entries may be None).

    Returns one :class:`SolveResult` a channel, each equal to
    :func:`value_iteration_converged` of that channel alone: values,
    argmin, ``num_sweeps``, ``converged`` and ``checks``.
    """
    convergence_stop(0.0, 0.0, tol, tol_mode)     # validate tol_mode early
    n_ch = len(batch)
    cur, nxt, argmin = batch.buffers(init_values)
    on_check = list(on_check) if on_check is not None else [None] * n_ch
    n_checks = max(max_sweeps // check_every, 1)
    checks = [torch.zeros((n_checks, 3), dtype=torch.float32)
              for _ in range(n_ch)]
    prev = [(torch.zeros((), dtype=torch.float32),) * 2] * n_ch
    c_idx = 0
    results = [None] * n_ch
    active = tuple(range(n_ch))
    graphs = {}

    def step(src, dst):
        batch.sweep(src, dst, argmin, active)

    def finish(c, num_sweeps, converged, v=None, a=None):
        with span("ocdp.engine.finish"):
            v = batch.to_natural(c, cur[c]) if v is None else v
            a = batch.to_natural(c, argmin[c]) if a is None else a
            pdt = (policy_dtype_for(batch.backups[c].args.n_actions)
                   if narrow_argmin_result else torch.int32)
            results[c] = SolveResult(
                values=v, argmin=a.to(pdt), policies=None,
                num_sweeps=num_sweeps, converged=converged,
                checks=checks[c].to(v.device))

    for n, k_s, is_check in converged_schedule(max_sweeps, check_every):
        if batch.launcher is not None and n == check_every:
            if active not in graphs:
                with span("ocdp.engine.prepare"):
                    batch.prepare(active)
                graphs[active] = SweepGraph(step, cur, nxt, n,
                                            (batch.launcher,))
            with span("ocdp.engine.sweeps", str(n)):
                graphs[active].replay()
        else:
            with span("ocdp.engine.sweeps", str(n)):
                ping_pong(step, cur, nxt, n)
        if not is_check:
            continue
        with span("ocdp.engine.check"):
            # each channel's sums from its own natural-order copy, brought
            # to the host together: one wait for the device a check
            nat = {c: (batch.to_natural(c, cur[c]),
                       batch.to_natural(c, argmin[c])) for c in active}
            sums = torch.stack([x.sum(dtype=torch.float32)
                                for c in active for x in nat[c]]).cpu()
            still = []
            for i, c in enumerate(active):
                v, a = nat[c]
                fsum, usum = sums[2 * i], sums[2 * i + 1]
                err_f, err_u = fsum - prev[c][0], usum - prev[c][1]
                stop = convergence_stop(float(err_f), float(fsum), tol,
                                        tol_mode)
                checks[c][c_idx] = torch.stack(
                    [torch.tensor(float(k_s)), err_f, err_u])
                if on_check[c] is not None:
                    on_check[c](k_s, float(err_f), float(err_u))
                prev[c] = (fsum, usum)
                if stop:
                    finish(c, max_sweeps - k_s + 1, True, v, a)
                else:
                    still.append(c)
        c_idx += 1
        active = tuple(still)
        if not active:
            break
    for c in active:
        finish(c, max_sweeps, False)
    return results


def _is_check_sweep(sweep: int, num_sweeps: int, check_every: int) -> bool:
    """Whether :func:`value_iteration_converged` over ``num_sweeps`` checks
    its stop rule right after its ``sweep``-th sweep (1-based): its
    countdown ``k_s = num_sweeps - sweep + 1`` is then a multiple of
    ``check_every``."""
    return (num_sweeps - sweep + 1) % check_every == 0


def value_iteration_segmented(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    *,
    segment_size: int = 100,
    init_values: Optional[torch.Tensor] = None,
    start_sweep: int = 0,
    prev_f: Optional[float] = None,
    backup=None,
    store_policies: bool = False,
    policy_dtype: Optional[torch.dtype] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_axes=None,
    on_segment=None,
    tol: Optional[float] = None,
    tol_mode: str = "abs",
    narrow_argmin_result: bool = False,
) -> SolveResult:
    """The finite-horizon solve in segments of at most ``segment_size``
    sweeps, each through :func:`value_iteration_finite`, with control back
    on the host between segments:

    * **policy streaming**: with ``store_policies``, each segment's per-sweep
      policies (in ``policy_dtype``, by default the narrowest that holds the
      actions, :func:`policy_dtype_for`; one too narrow raises) go to HOST
      numpy at once, so the device holds one segment of them;
      ``SolveResult.policies`` is then a numpy array of shape ``(sweeps
      done, *state_shape)``;
    * **checkpoints**: with ``checkpoint_path``, the value table, the sweep
      index and the stop rule's last checksum ``prev_f`` are written
      (:func:`~ocdp_tpu_torch.io.save_values`) after every segment: the
      table is copied into a :class:`~ocdp_tpu_torch.io.CheckpointWriter`'s
      staging buffer and the file written on its thread while the next
      segment sweeps; the last segment's is complete when the call
      returns, and so is every one started when it raises;
    * **resume**: pass ``init_values``, ``start_sweep`` and ``prev_f`` from
      :func:`~ocdp_tpu_torch.io.load_values` to continue a solve; the result
      is bitwise the uninterrupted one;
    * **early stop**: with ``tol``, the stop rule of
      :func:`value_iteration_converged` with ``check_every=segment_size``
      over the same ``num_sweeps``. Segment ends are aligned to that
      engine's check sweeps, and the rule is evaluated at a segment end only
      when it is one, so the stop decision, the sweep count and the values
      are the converged engine's. ``prev_f`` (None: no check yet, the
      converged engine's 0.0) is the checksum of the last check.

    ``on_segment(sweep_index, values)`` is an optional host callback after
    each segment (e.g. :meth:`~ocdp_tpu_torch.profiling.SweepTimer.
    on_segment`). ``SolveResult.num_sweeps`` counts the sweeps this call ran.

    With a carry-mode backup the engine allocates the carry's two tables
    and its argmin buffer (in the backup's narrow dtype) once and hands
    them from segment to segment, so nothing table-sized is copied or
    allocated per segment; a flat plan's checkpoints and results then hold
    the ``(NW, NE)`` table, which ``init_values`` takes back; the table
    ``on_segment`` gets is the engine's buffer, which later segments
    overwrite. ``narrow_argmin_result`` governs only the result's argmin.
    ``store_policies`` is refused with such a backup, as in the JAX
    package.
    """
    if segment_size < 1:
        raise ValueError(f"segment_size must be >= 1, got {segment_size}")
    pdt = _policy_dtype(policy_dtype, plan.query_shape[-1])
    carry = getattr(backup, "carry_padded", False)
    if carry and store_policies:
        raise ValueError(
            "store_policies is unsupported with a carry-mode backup "
            "(per-sweep policy stacks defeat the envelope memory budget)")
    if tol is not None:
        convergence_stop(0.0, 0.0, tol, tol_mode)     # validate tol_mode
    if carry:
        # the solve's only table-sized buffers: two tables and the narrow
        # argmin, handed from segment to segment
        v, spare, argmin = _carry_buffers(plan, backup, init_values)
    else:
        v = _initial_values(plan, init_values)
        argmin = torch.zeros(plan.grid_shape, dtype=torch.int32,
                             device=v.device)
    host_policies = [] if store_policies else None
    sweep = start_sweep
    converged = False
    with CheckpointWriter() as writer:
        while sweep < num_sweeps and not converged:
            n = min(segment_size, num_sweeps - sweep)
            if tol is not None:
                # end the segment at the converged engine's next check sweep
                # (it checks after sweep s when (num_sweeps - s + 1) is a
                # multiple of segment_size)
                r = (num_sweeps + 1) % segment_size
                n = min(((r - sweep - 1) % segment_size) + 1,
                        num_sweeps - sweep)
            if carry:
                v, spare = _carry_sweeps(backup, v, spare, argmin, n)
            else:
                res = value_iteration_finite(
                    plan, stage_cost, n, init_values=v,
                    store_policies=store_policies, policy_dtype=pdt,
                    backup=backup, narrow_argmin_result=narrow_argmin_result)
                v, argmin = res.values, res.argmin
                if store_policies:
                    host_policies.append(res.policies.cpu().numpy())
            sweep += n
            if tol is not None and _is_check_sweep(sweep, num_sweeps,
                                                   segment_size):
                with span("ocdp.engine.check"):
                    fsum = v.sum(dtype=torch.float32).cpu()
                    err_f = fsum - torch.tensor(prev_f or 0.0,
                                                dtype=torch.float32)
                    converged = convergence_stop(float(err_f), float(fsum),
                                                 tol, tol_mode)
                    prev_f = float(fsum)
            table = _carry_view(plan, v) if carry else v
            if checkpoint_path is not None:
                # written on the writer's thread while the next segment
                # sweeps; the solve's last one is waited for at once
                save_values(checkpoint_path, table, sweep,
                            checkpoint_axes if checkpoint_axes is not None
                            else (), prev_f=prev_f, writer=writer,
                            wait=sweep >= num_sweeps or converged)
            if on_segment is not None:
                on_segment(sweep, table)

    if carry:
        del spare
        return _carry_result(plan, v, argmin, narrow_argmin_result,
                             sweep - start_sweep, converged)
    policies = (np.concatenate(host_policies, axis=0) if host_policies
                else None)
    return SolveResult(
        values=v,
        argmin=argmin if narrow_argmin_result else argmin.to(torch.int32),
        policies=policies,
        num_sweeps=sweep - start_sweep,
        converged=converged,
    )
