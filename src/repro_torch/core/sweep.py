"""Batched scenario-sweep engine; port of ``repro.core.sweep``.

A sweep is a grid of labelled configurations × seeds. The engine groups the
configurations by their structural signature (``STATIC_FIELDS``: anything
that changes the round's program) and runs each group as ONE batched run:
the group's cells (points × seeds, G of them, point-major) ride the
written-out leading cell axis of ``simulator.make_param_round_fn``, every
scalar knob a [G] vector. The reference compiles one vmapped scan a group;
here a group's round issues its PyTorch launches once for all G cells, and
its eq. (10) kernel once per cell.

Usage::

    specs  = expand_grid(base_fl, variants={"afl": {"method": "afl"},
                                            "c8": {"method": "ca_afl",
                                                   "energy_C": 8.0}},
                         scenarios=("default", "noisy_uplink"))
    result = run_sweep(model, data, specs, seeds=(0, 1, 2, 3, 4))
    result.summary()          # per-label mean/std/worst-case across seeds
    result.pareto_front()     # energy-vs-robustness Pareto extraction

Cell (point p, seed s) draws what ``run_simulation(fl_p, seed=s)`` draws
(``draws.round_draws`` and ``draws.init_draws``), so a group equals its
cells run one by one. Every knob of a point is an f32 device tensor, so the
round never copies a knob from the host. A group of temporal cells carries
each cell's process state on the cell axis, and a GCA group runs the
[N, model] round; both are one batched run like any other group.

A group of the sharded control plane (``control_plane="sharded"``) is one
batched run of the sharded round over [G] cells, each with its own
id-addressed source (``draws.CellDraws``). On a mesh of ``devices`` ranks
(``torch.distributed``), each rank runs its share of every group's seed
columns and the histories are all-gathered; sharded-plane groups may also
split their client rows over a clients axis (the 2-D cells × clients
mesh, ``sharding.cells_clients_axes``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, replace
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, GCAParams
from repro_torch.core.channel import (SCENARIOS, ChannelScenario,
                                      scenario_from_config)
from repro_torch.core.draws import (CellDraws, HashDraws, draw_signature,
                                    init_draws, round_draws, stack_draws,
                                    stack_init_draws)
from repro_torch.core.dynamics import ChannelProcess, process_from_config
from repro_torch.core.sharding import control_sharded_cell_run
from repro_torch.core.simulator import (SimHistory, check_supported,
                                        init_sim_state, make_param_round_fn,
                                        run_rounds)
from repro_torch.core.transport import TransportParams, transport_from_config
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_size

__all__ = [
    "SweepPoint", "SweepResult", "sweep_point_from_config", "expand_grid",
    "run_sweep", "trace_count", "reset_trace_log", "pareto_indices",
]


@dataclass(frozen=True)
class SweepPoint:
    """The round's device knobs: f32 scalars for one configuration, [G]
    vectors (``stack_points``) for a group of cells."""

    scenario: ChannelScenario
    lr0: Any = 0.1
    lr_decay: Any = 0.998
    ascent_lr: Any = 8e-3
    energy_C: Any = 8.0
    gca: Any = GCAParams()             # GCA's knobs (structural: nothing)
    process: Any = ChannelProcess()    # temporal process (structural: temporal)
    transport: Any = TransportParams()
    method: str = "ca_afl"


def sweep_point_from_config(fl: FLConfig, device=None) -> SweepPoint:
    """Promote an ``FLConfig``'s scalar knobs to f32 scalars on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return SweepPoint(
        scenario=scenario_from_config(fl, device),
        lr0=f32(fl.lr0),
        lr_decay=f32(fl.lr_decay),
        ascent_lr=f32(fl.ascent_lr),
        energy_C=f32(fl.energy_C),
        gca=GCAParams(*(f32(v) for v in fl.gca)),
        process=process_from_config(fl, device),
        transport=transport_from_config(fl, device),
        method=fl.method,
    )


def _stack_fields(objs: Sequence[Any]):
    """Stack the tensor fields of equal dataclasses and NamedTuples
    (recursively); a field that is not a tensor (``flat``, ``temporal``,
    ``scheme``, ``method``) must agree."""
    first = objs[0]
    if isinstance(first, tuple):   # a NamedTuple of tensors (GCAParams)
        return type(first)(*(torch.stack(vals) for vals in zip(*objs)))
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(o, f.name) for o in objs]
        if dataclasses.is_dataclass(vals[0]) or isinstance(vals[0], tuple):
            out[f.name] = _stack_fields(vals)
        elif isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        else:
            if any(v != vals[0] for v in vals):
                raise ValueError(f"{f.name} differs within a group: {vals}")
            out[f.name] = vals[0]
    return type(first)(**out)


def stack_points(points: Sequence[SweepPoint]) -> SweepPoint:
    """One point per cell → one point of [G] knobs (``pathloss`` [G, N])."""
    return _stack_fields(points)


# Structural FLConfig fields: changing one changes the round's program, so
# specs are grouped by this signature (the reference's tuple, one group a
# signature; test-pinned equal to ``repro.core.sweep.STATIC_FIELDS``).
STATIC_FIELDS: Tuple[str, ...] = (
    "num_clients", "clients_per_round", "rounds", "batch_size", "local_steps",
    "num_subcarriers", "flat_fading", "temporal", "eval_every", "transport",
    "sparse_density", "method", "control_plane", "record_lambda_every",
)


def _static_signature(fl: FLConfig) -> Tuple:
    return tuple(getattr(fl, f) for f in STATIC_FIELDS)


# ---------------------------------------------------------------------------
# Grid expansion: variants × named scenarios -> labelled FLConfigs
# ---------------------------------------------------------------------------


def expand_grid(
    base: FLConfig,
    variants: Optional[Mapping[str, Mapping[str, Any]]] = None,
    scenarios: Sequence[Any] = ("default",),
) -> list[Tuple[str, FLConfig]]:
    """Cross method/hyperparameter ``variants`` with channel ``scenarios``.

    ``variants`` maps label -> FLConfig field overrides; ``scenarios`` entries
    are names from :data:`repro_torch.core.channel.SCENARIOS`, raw override
    dicts (labelled by their contents, e.g. ``noise_std=0.01``), or explicit
    ``(name, overrides)`` pairs. Returns ``[(label, config), ...]`` ready
    for :func:`run_sweep`.
    """
    variants = dict(variants or {"base": {}})
    specs = []
    for sc in scenarios:
        if isinstance(sc, str):
            sc_name, sc_kw = sc, SCENARIOS[sc]
        elif isinstance(sc, tuple):
            sc_name, sc_kw = sc[0], dict(sc[1])
        else:
            sc_kw = dict(sc)
            sc_name = ",".join(f"{k}={v:g}" if isinstance(v, float) else
                               f"{k}={v}" for k, v in sc_kw.items()) or "default"
        # only the true baseline (no overrides) drops the @suffix
        baseline = sc_name == "default" and not sc_kw
        for vlabel, vkw in variants.items():
            label = vlabel if baseline else f"{vlabel}@{sc_name}"
            specs.append((label, replace(base, **{**sc_kw, **vkw})))
    return specs


# ---------------------------------------------------------------------------
# Group accounting (kept under the reference's names)
# ---------------------------------------------------------------------------

_TRACE_LOG: list[str] = []


def trace_count() -> int:
    """Number of batched group runs since the last reset: one per
    structural group that ran (a group restored from a checkpoint runs
    none). The reference counts its compilations here, one per group;
    PyTorch compiles nothing, so this counts the runs that stand in for
    them."""
    return len(_TRACE_LOG)


def reset_trace_log() -> None:
    _TRACE_LOG.clear()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _group_draws(fls, seeds, labels, draws, noise: bool, model_size: int,
                 shard_size: int, device):
    """The group's batched ``RoundDraws``, one a round, cells point-major:
    each cell's ``draws(label, fl, seed)`` if given, else its
    ``round_draws(seed, fl)``, one stream shared by the cells with the same
    seed and draw signature."""
    streams, keys = {}, []
    for lbl, fl in zip(labels, fls):
        for s in seeds:
            key = (lbl, s) if draws is not None else (s, draw_signature(fl))
            if key not in streams:
                streams[key] = iter(
                    draws(lbl, fl, s) if draws is not None
                    else round_draws(s, fl, model_size, shard_size, device))
            keys.append(key)
    for _ in range(fls[0].rounds):
        now = {k: next(it).to(device) for k, it in streams.items()}
        yield stack_draws([now[k] for k in keys], noise, model_size)


def _run_group(model, data, fls, labels, seeds, draws, device, model_size,
               init=None):
    """One structural group's batched run: the history of its G = points ×
    seeds cells, point-major, as [G, T, ...] device tensors. Each cell's
    initial state comes from its point's process and its own
    ``init(label, fl, seed)`` (default ``draws.init_draws(seed, fl)``)."""
    fl0 = fls[0]
    cells = len(fls) * len(seeds)
    points = [sweep_point_from_config(fl, device) for fl in fls]
    point = stack_points([p for p in points for _ in seeds])
    # elide the eq.-(10) noise only if the whole group is noise-free; a
    # quiet cell of a noisy group reads a zero AWGN row from its own stream
    noise_free = all(fl.noise_std == 0 for fl in fls)
    inits = stack_init_draws([
        (init(lbl, fl, s) if init is not None else init_draws(s, fl, device))
        .to(device) for lbl, fl in zip(labels, fls) for s in seeds])
    state = init_sim_state(model, fl0, device, cells=cells,
                           process=point.process, init=inits)
    round_fn = make_param_round_fn(model, fl0, data, model_size, fl0.method,
                                   noise_free=noise_free, cells=cells)
    _TRACE_LOG.append(fl0.method)
    return run_rounds(round_fn, point, state, fl0,
                      _group_draws(fls, seeds, labels, draws, not noise_free,
                                   model_size, data[1].shape[1], device))


def _run_sharded_group(model, data, fls, labels, seeds, draws, device,
                       model_size, axis=None):
    """One group of the sharded control plane as one batched [G] run
    (``sharding.control_sharded_cell_run``), G = points × seeds cells,
    point-major, over this rank's client rows of ``data`` (``axis``: the
    clients axis of a 2-D mesh; None: all N rows). Cell (p, s) draws from
    ``draws(label, fl, seed)`` if given (an ``IdDraws``), else from
    ``HashDraws(s)``, as ``run_simulation(fl_p, seed=s)`` does. Returns the
    [G, T, ...] history, λ gathered over the clients axis."""
    fl0 = fls[0]
    n_local = fl0.num_clients // (1 if axis is None else axis.size)
    off = 0 if axis is None else axis.rank * n_local
    points = [sweep_point_from_config(fl, device) for fl in fls]
    point = stack_points([p for p in points for _ in seeds])
    noise_free = all(fl.noise_std == 0 for fl in fls)
    sources = CellDraws([draws(lbl, fl, s) if draws is not None
                         else HashDraws(s, device)
                         for lbl, fl in zip(labels, fls) for s in seeds])
    run = control_sharded_cell_run(model, fl0, fl0.method, axis, n_local,
                                   model_size, noise_free=noise_free)
    _TRACE_LOG.append(fl0.method)
    hist = run(point, sources, *(a[off:off + n_local] for a in data))
    if axis is not None and not isinstance(hist.lam, tuple):
        hist = hist._replace(lam=axis.all_gather(hist.lam, dim=-1))
    return hist


def _split_cells(hist: SimHistory, points: int, num_seeds: int,
                 cells_axis=None) -> list:
    """A group's [G', T, ...] history (G' = points × this rank's seed
    columns) as one numpy ``SimHistory`` a point with leaves [R, T, ...]:
    the seed columns gathered over ``cells_axis`` in rank order and the
    padding columns dropped."""
    def split(v):
        v = v.reshape(points, -1, *v.shape[1:])
        if cells_axis is not None:
            v = cells_axis.all_gather(v, dim=1)
        return v[:, :num_seeds].cpu().numpy()

    cols = [v if isinstance(v, tuple) else split(v) for v in hist]
    return [SimHistory(*(v if isinstance(v, tuple) else v[p] for v in cols))
            for p in range(points)]


def _grid_fingerprint(specs, seeds) -> np.ndarray:
    """A [32] uint8 digest of the full grid — labels, every config field,
    seed list and order — stored in the resume checkpoint, so a rerun whose
    grid differs in any way fails instead of resuming misattributed
    histories (the 'done' flags are positional). The port's ``FLConfig``
    prints as the reference's, so the digest is the reference's too."""
    import hashlib

    desc = repr([(lbl, fl) for lbl, fl in specs]) + repr(tuple(seeds))
    return np.frombuffer(hashlib.sha256(desc.encode()).digest(), np.uint8)


def _history_template(fl: FLConfig, num_seeds: int) -> SimHistory:
    """Zero-filled [R, T(, N)] SimHistory with the shapes and dtypes
    run_sweep produces — the restore template of the checkpoint resume."""
    r, t, n = num_seeds, fl.rounds, fl.num_clients
    e = fl.record_lambda_every
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    lam = () if e == 0 else (z(r, t, n) if e == 1
                             else z(r, (t + e - 1) // e, n))
    return SimHistory(avg_acc=z(r, t), worst_acc=z(r, t), std_acc=z(r, t),
                      energy=z(r, t), loss=z(r, t), num_scheduled=z(r, t),
                      lam=lam, avail_count=z(r, t),
                      min_battery=z(r, t), lam_max=z(r, t),
                      lam_entropy=z(r, t), lam_ess=z(r, t),
                      dl_energy=z(r, t))


def run_sweep(
    model,
    data,
    specs: Sequence[Tuple[str, FLConfig]],
    seeds: Sequence[int] = (0,),
    devices=None,
    client_devices: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    draws: Optional[Callable] = None,
    device=None,
    init_draws: Optional[Callable] = None,
) -> "SweepResult":
    """Run every (spec × seed) cell, one batched run per structural group.

    ``specs`` is ``[(label, FLConfig), ...]`` (see :func:`expand_grid`).
    Returns a :class:`SweepResult` whose per-label histories have a leading
    seed axis [R] on every leaf (numpy arrays).

    ``device`` is where the runs go (``None``: the card). ``draws``, if
    given, is ``(label, fl, seed) -> T RoundDraws``, a cell's own draws
    (e.g. the reference's numbers in a test), or for a group of
    ``control_plane="sharded"`` the cell's ``draws.IdDraws``; by default
    cell (p, s) draws what ``run_simulation(fl_p, seed=s)`` does.
    ``init_draws``, likewise, is ``(label, fl, seed) -> InitDraws``, a
    replicated cell's initial draws (a temporal cell's initial fading
    normals). A sharded-plane group is one batched [G] run of the sharded
    round.

    ``devices`` (None or 1: one device) asks for a mesh of that many ranks
    of an initialized ``torch.distributed`` process group ("auto": all of
    them): every rank calls ``run_sweep`` with the same arguments and its
    own ``device``, and every rank gets the one-device result. A group's
    seeds are split over a cells axis, padded to a multiple of its ranks
    (the padding columns are run and dropped): each rank runs its seed
    columns of every point of the group as one batched group, and the
    histories are all-gathered. ``client_devices`` (sharded-plane groups)
    factors the ranks into the 2-D cells × clients mesh of
    ``sharding.cells_clients_axes``: each group runs its cells' client
    rows split over the clients axis and its seed columns over the cells
    axis; None picks the largest divisor of ``devices`` that divides N
    (``sharding.factor_client_devices``), and replicated-plane groups
    always take a pure cells mesh. A world of more ranks than ``devices``
    holds world / devices such meshes, each running the whole sweep.

    ``checkpoint_dir`` (opt-in resume): after each group completes, the
    per-label histories land in a ``repro_torch.checkpoint`` msgpack
    checkpoint (the reference's format and keys); a rerun with the same
    specs, seeds and directory restores the finished groups and runs only
    the rest. A changed grid fails ("shape mismatch" from the restore
    template, or "different sweep grid" from the fingerprint). On a mesh
    every rank restores, rank 0 of the world alone writes, and a barrier
    follows each write.
    """
    from repro_torch.core import sharding

    labels = [lbl for lbl, _ in specs]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate sweep labels: {labels}")
    for _, fl in specs:
        check_supported(fl)
    n_dev = sharding.resolve_device_count(devices)
    if client_devices is not None and (
            isinstance(client_devices, bool)
            or not isinstance(client_devices, (int, np.integer))
            or client_devices < 1 or n_dev % client_devices):
        raise ValueError(f"client_devices={client_devices!r} must be a "
                         f"positive int dividing devices={n_dev}")
    multi = n_dev > 1
    if multi:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"devices={n_dev} needs an initialized torch.distributed "
                "process group: one process a device, each calling run_sweep")
    dev = resolve_device(device)
    seeds = tuple(int(s) for s in seeds)
    num_seeds = len(seeds)

    groups: dict[Tuple, list[int]] = {}
    for i, (_, fl) in enumerate(specs):
        groups.setdefault(_static_signature(fl), []).append(i)

    # ---- checkpoint resume hook (opt-in) -------------------------------
    done = np.zeros((len(specs),), np.float32)
    histories: list[Optional[SimHistory]] = [None] * len(specs)
    writer = not multi or dist.get_rank() == 0
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.ckpt import (latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
        ckpt_template = {
            "done": np.zeros((len(specs),), np.float32),
            "grid": _grid_fingerprint(specs, seeds),
            "hist": {lbl: _history_template(fl, num_seeds)
                     for lbl, fl in specs},
        }
        if latest_step(checkpoint_dir) is not None:
            restored = restore_checkpoint(checkpoint_dir, ckpt_template)
            if not np.array_equal(restored["grid"], ckpt_template["grid"]):
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} was written by a "
                    "different sweep grid (labels/configs/seeds changed or "
                    "reordered) — resuming would misattribute histories; "
                    "point checkpoint_dir elsewhere or delete the stale "
                    "checkpoint")
            done = restored["done"].copy()
            for i, lbl in enumerate(labels):
                if done[i]:
                    histories[i] = restored["hist"][lbl]
        if multi:
            dist.barrier()   # every rank has read before rank 0 writes

    data = tuple(torch.as_tensor(a).to(dev) for a in data)
    model_size = tree_size(model.init(dev))
    groups_done = sum(1 for idxs in groups.values() if all(done[i] for i in idxs))
    for idxs in groups.values():
        if all(done[i] for i in idxs):
            continue  # restored from the checkpoint
        fls = [specs[i][1] for i in idxs]
        lbls = [labels[i] for i in idxs]
        fl0 = fls[0]
        sharded = fl0.control_plane == "sharded"
        c = (sharding.factor_client_devices(fl0.num_clients, n_dev,
                                            client_devices)
             if multi and sharded else 1)
        cells_axis, clients_axis = (sharding.cells_clients_axes(n_dev, c)
                                    if multi else (None, None))
        # the seeds padded to a multiple of the cells axis, this rank's
        # columns of them
        rows = n_dev // c
        run_seeds = sharding.pad_to_multiple(seeds, rows)
        per = len(run_seeds) // rows
        q = 0 if cells_axis is None else cells_axis.rank
        mine = run_seeds[q * per:(q + 1) * per]
        if sharded:
            hist = _run_sharded_group(model, data, fls, lbls, mine, draws, dev,
                                      model_size, axis=clients_axis)
        else:
            hist = _run_group(model, data, fls, lbls, mine, draws, dev,
                              model_size, init=init_draws)
        for i, h in zip(idxs, _split_cells(hist, len(idxs), num_seeds,
                                           cells_axis)):
            histories[i] = h
            done[i] = 1.0
        if checkpoint_dir is not None:
            groups_done += 1
            if writer:
                tree = {"done": done, "grid": ckpt_template["grid"],
                        "hist": {lbl: (histories[i] if done[i]
                                       else ckpt_template["hist"][lbl])
                                 for i, lbl in enumerate(labels)}}
                save_checkpoint(checkpoint_dir, groups_done, tree, keep=1)
            if multi:
                dist.barrier()

    return SweepResult(labels=labels, configs=[fl for _, fl in specs],
                       seeds=seeds, histories=histories)


# ---------------------------------------------------------------------------
# Aggregation: seed statistics + energy/robustness Pareto extraction
# ---------------------------------------------------------------------------


def pareto_indices(costs: np.ndarray, utilities: np.ndarray) -> list[int]:
    """Indices on the (minimize cost, maximize utility) Pareto frontier."""
    keep = []
    for i in range(len(costs)):
        dominated = np.any(
            (costs <= costs[i]) & (utilities >= utilities[i])
            & ((costs < costs[i]) | (utilities > utilities[i])))
        if not dominated:
            keep.append(i)
    return sorted(keep, key=lambda i: costs[i])


@dataclass
class SweepResult:
    """Sweep output: per-label seed-batched histories + aggregation helpers."""

    labels: list[str]
    configs: list[FLConfig]
    seeds: Tuple[int, ...]
    histories: list[SimHistory]  # numpy leaves [R, T, ...] per label

    def __post_init__(self):
        self._by_label = {lbl: i for i, lbl in enumerate(self.labels)}

    def history(self, label: str) -> SimHistory:
        """Per-seed history for one label (leaves [R, T, ...])."""
        return self.histories[self._by_label[label]]

    def mean_history(self, label: str) -> SimHistory:
        """Seed-averaged history (leaves [T, ...])."""
        return SimHistory(*(v if isinstance(v, tuple) else v.mean(0)
                            for v in self.history(label)))

    def summary(self, window: int = 10) -> dict:
        """Per-label statistics over the final ``window`` *evaluated* rounds,
        as the reference computes them: mean/std across seeds of the average
        and worst-client accuracy, the worst case (min over seeds) of the
        worst-client accuracy, and the final cumulative energy.

        Under ``eval_every = E > 1`` the accuracy window ranges over the
        label's eval rounds (``t % E == 0``) only, never over forward-filled
        copies; per-round quantities keep the plain tail window. The λ
        statistics window over the last ``window`` *recorded* λ rows (the
        ``record_lambda_every`` cadence), and at E = 0 fall back to the
        per-round summary leaves (max / entropy / effective support size).
        """
        out = {}
        for lbl in self.labels:
            h = self.history(lbl)
            cfg = self.configs[self._by_label[lbl]]
            rounds = np.asarray(h.avg_acc).shape[1]
            eval_idx = np.arange(0, rounds, max(1, cfg.eval_every))[-window:]
            avg = np.asarray(h.avg_acc)[:, eval_idx].mean(1)     # [R]
            worst = np.asarray(h.worst_acc)[:, eval_idx].mean(1)  # [R]
            std = np.asarray(h.std_acc)[:, eval_idx].mean(1)     # [R]
            energy = np.asarray(h.energy)[:, -1]                 # [R]
            dl_energy = np.asarray(h.dl_energy)[:, -1]           # [R]
            sched = np.asarray(h.num_scheduled)[:, -window:].mean(1)  # [R]
            avail = np.asarray(h.avail_count)[:, -window:].mean(1)    # [R]
            min_batt = float(np.asarray(h.min_battery)[:, -1].mean())
            lam = np.asarray(h.lam) if not isinstance(h.lam, tuple) else None
            if lam is not None and lam.size:
                la = lam[:, -window:, :]
                lam_max = la.max(-1).mean(1)                          # [R]
                plogp = la * np.log(np.where(la > 0, la, 1.0))
                lam_entropy = (-plogp.sum(-1)).mean(1)                # [R]
                lam_ess = (1.0 / np.maximum(
                    (la ** 2).sum(-1), np.finfo(la.dtype).tiny)).mean(1)
            else:
                lam_max = np.asarray(h.lam_max)[:, -window:].mean(1)
                lam_entropy = np.asarray(h.lam_entropy)[:, -window:].mean(1)
                lam_ess = np.asarray(h.lam_ess)[:, -window:].mean(1)
            out[lbl] = {
                "avg_acc": float(avg.mean()),
                "avg_acc_std": float(avg.std()),
                "worst_acc": float(worst.mean()),
                "worst_acc_std": float(worst.std()),
                "worst_case_acc": float(worst.min()),
                "client_std": float(std.mean()),
                "energy": float(energy.mean()),
                "energy_std": float(energy.std()),
                # downlink share of the total `energy` column
                "dl_energy": float(dl_energy.mean()),
                "num_scheduled": float(sched.mean()),
                "avail_count": float(avail.mean()),
                # None (JSON null) for static scenarios, where it is +inf
                "min_battery": min_batt if np.isfinite(min_batt) else None,
                "lam_max": float(lam_max.mean()),
                "lam_entropy": float(lam_entropy.mean()),
                "lam_ess": float(lam_ess.mean()),
            }
        return out

    def pareto_front(self, window: int = 10, cost: str = "energy",
                     utility: str = "worst_acc") -> list[str]:
        """Labels on the energy-vs-robustness Pareto frontier."""
        s = self.summary(window)
        costs = np.array([s[lbl][cost] for lbl in self.labels])
        utils = np.array([s[lbl][utility] for lbl in self.labels])
        return [self.labels[i] for i in pareto_indices(costs, utils)]

    def to_dict(self, window: int = 10) -> dict:
        return {
            "labels": self.labels,
            "seeds": list(self.seeds),
            "summary": self.summary(window),
            "pareto_energy_vs_worst_acc": self.pareto_front(window),
        }

    def save_json(self, path, window: int = 10, extra: Optional[dict] = None):
        payload = self.to_dict(window)
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return payload
