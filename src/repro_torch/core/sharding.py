"""The client mesh of the sharded control plane; port of the collective
layer of ``repro.core.sharding``.

The reference shards its client population over a ``shard_map`` mesh axis.
Here one ``torch.distributed`` process group stands for that axis: a
:class:`ClientAxis` wraps it (its rank and size, ``psum``, ``pmax``,
``pmin`` and a tiled ``all_gather``, the list form that both gloo and NCCL
take), and ``None`` means the unsharded program, all N rows on one device.
Rank d holds the client rows [d·N/D, (d+1)·N/D).

Under ``control_plane="sharded"`` each rank keeps only its rows of the
data, λ, the temporal ``ChanState`` and every per-round draw (addressed by
global client id, ``core/draws.py``):

  - exact-K selection is :func:`hierarchical_top_k`: each shard's top-k
    candidates, then a gather and top-k within contiguous groups of shards,
    then one gather across the groups' representatives. Ties resolve to the
    lowest global index at every level, as one sort of the whole vector
    would. The stages are pure functions over gathered candidates
    (:func:`shard_candidates`, :func:`merge_candidates`), so
    :func:`tree_top_k` runs the same tree in one process at any D;
  - the K winners' rows are assembled on every rank by ownership: each
    rank contributes its owned rows and exact zeros elsewhere
    (``torch.where``, never a product: 0·inf is NaN), and a ``psum`` adds
    them (:func:`assemble_rows`, :func:`assemble_batch_rows`), so a slot
    equals a gather on one device bit for bit;
  - the simplex projection is a bisection on the water level with one
    ``psum`` an iteration (:func:`project_simplex_sharded`), no gather and
    no sort.

No collective of a round moves O(N) values, except GCA's threshold
statistics (the median has no psum form). The λ history, a rank's own
rows, is gathered once at the end of a run (:func:`run_simulation_control_sharded`).

The tree's groups (``dist.new_group``) are made lazily, the first time a
fan-in is used, by every rank of the world in one order: the axis knows
the ranks of every axis like it (its ``siblings``, the rows of a 2-D mesh),
and each rank makes the groups of all of them (:func:`tree_group_layout`).

Every primitive works on the last axis, so a sweep group's [G] cells ride
along as a leading axis: one collective moves the whole group's [G, ...]
(one ``psum`` a bisection step for all G cells).

The other meshes of the reference:

  - **population sharding** of the replicated control plane
    (:func:`run_simulation_sharded`): every [N] draw replicated on every
    rank, the model-sized work (local SGD, losses, the test eval) on the
    rank's own client rows, eq. (10) a local partial sum and a ``psum``;
  - **sweep cells over ranks** (``sweep.run_sweep(devices=n)``): a
    :class:`CellAxis` of n ranks splits every group's seed columns, and an
    ``all_gather`` puts the histories back together;
  - **the 2-D cells × clients mesh** (:func:`cells_clients_axes`):
    ``n/c`` rows of sweep cells × ``c`` columns of client shards, the
    reference's ``cells_clients_mesh``; a sharded-plane group runs on the
    clients axis with its seed columns split over the cells axis.

Not ported yet: a parameter server on a mesh (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "ClientAxis", "CellAxis", "tree_group_layout", "mesh_layout",
    "cells_clients_axes", "resolve_device_count", "population_device_count",
    "factor_client_devices", "local_slice", "all_gather_axis", "top_k",
    "shard_candidates", "merge_candidates", "tree_top_k",
    "hierarchical_top_k", "distributed_top_k", "project_simplex_sharded",
    "global_client_ids", "assemble_rows", "assemble_batch_rows",
    "merge_owned_rows", "check_divisible",
    "control_sharded_cell_run", "run_simulation_control_sharded",
    "run_simulation_sharded", "pad_to_multiple",
]


class ClientAxis:
    """The clients mesh axis: a ``torch.distributed`` process group
    (default: the world) whose ranks hold equal, contiguous shards of the
    population, in rank order.

    ``siblings``: the global ranks of every axis made like this one, this
    one's among them (the rows of a 2-D mesh), which a top-k tree needs
    to make its groups; an axis spanning the world is its own layout."""

    def __init__(self, group=None, siblings=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = dist.get_process_group_ranks(self.group)
        if siblings is None and self.size == dist.get_world_size():
            siblings = [self.ranks]
        self.siblings = None if siblings is None else [list(r) for r in siblings]
        self._trees: dict[int, tuple] = {}

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone()
        self._dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
        """Every rank's ``x`` (same shape on each) concatenated along ``dim``
        in rank order; ``group`` a subgroup of this axis instead."""
        group = self.group if group is None else group
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(self._dist.get_world_size(group))]
        self._dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def tree_groups(self, g: int):
        """(this rank's contiguous group, its representative group) of a
        tree of fan-in ``g``: within each axis of the layout, contiguous
        groups [b·g, (b+1)·g) and representative groups {r, g + r, 2g + r,
        ...}. Every rank of the world makes every one of them, in the order
        of :func:`tree_group_layout`, once per fan-in."""
        if g not in self._trees:
            dist = self._dist
            if self.siblings is None:
                raise ValueError(
                    "a top-k tree on an axis that does not span the world "
                    "needs the ranks of every axis like it (siblings=..., "
                    "as cells_clients_axes makes them): dist.new_group is "
                    "collective over the world")
            me = dist.get_rank()
            mine = rep = None
            for kind, ranks in tree_group_layout(self.siblings, g):
                pg = dist.new_group(ranks)
                if me in ranks:
                    if kind == "block":
                        mine = pg
                    else:
                        rep = pg
            self._trees[g] = (mine, rep)
        return self._trees[g]


class CellAxis(ClientAxis):
    """The cells mesh axis: the ranks that split a sweep group's seed
    columns, in rank order. Its cells are independent, so the only
    collective it runs is the ``all_gather`` of the histories."""


def tree_group_layout(siblings, g: int) -> list:
    """The groups of a top-k tree of fan-in ``g`` over each axis in
    ``siblings`` (lists of global ranks), in the order every rank makes
    them: ``("block", ranks)`` for the contiguous groups of every axis,
    then ``("rep", ranks)`` for the representative groups of every axis."""
    out = []
    for col in siblings:
        out += [("block", [col[b * g + r] for r in range(g)])
                for b in range(len(col) // g)]
    for col in siblings:
        out += [("rep", [col[b * g + r] for b in range(len(col) // g)])
                for r in range(g)]
    return out


def mesh_layout(world: int, n_devices: int, client_devices: int):
    """``(cells groups, clients groups)`` of the 2-D cells × clients mesh
    in a world of ``world`` ranks, as lists of global ranks. The world
    holds world / n meshes of n consecutive ranks (each runs the same
    sweep); in a mesh whose first rank is b, rank b + i·c + j sits at row
    i and column j (the reference's ``cells_clients_mesh``: n/c rows of
    cells × c columns of clients), its clients axis is its row's c ranks
    and its cells axis its column's n/c ranks."""
    n, c = n_devices, client_devices
    if n < 1 or c < 1 or n % c or world % n:
        raise ValueError(f"a mesh of {n} devices with {c} on the clients "
                         f"axis does not tile a world of {world} ranks")
    rows = n // c
    cells, clients = [], []
    for b in range(0, world, n):
        clients += [[b + i * c + j for j in range(c)] for i in range(rows)]
        cells += [[b + i * c + j for i in range(rows)] for j in range(c)]
    return cells, clients


# the axes made by cells_clients_axes, {(n, c): axes}, and the process
# group they were made in: a new group (after destroy_process_group)
# drops them, since their subgroups died with the old one
_MESHES: dict = {"world": None, "axes": {}}


def cells_clients_axes(n_devices: int, client_devices: int = 1):
    """This rank's ``(cells axis, clients axis)`` of the 2-D mesh of
    :func:`mesh_layout` over the initialized process group: a
    :class:`CellAxis` and a :class:`ClientAxis` (siblings: every clients
    axis of the world), ``None`` for an axis of one rank. Every rank makes
    every group of size > 1, cells groups first, in one order; the axes
    are made once per (n, c) and process group."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if _MESHES["world"] is not dist.group.WORLD:
        _MESHES["world"], _MESHES["axes"] = dist.group.WORLD, {}
    meshes = _MESHES["axes"]
    key = (int(n_devices), int(client_devices))
    if key not in meshes:
        me = dist.get_rank()
        cells, clients = mesh_layout(world, n_devices, client_devices)
        axes = []
        for kind, layout in ((CellAxis, cells), (ClientAxis, clients)):
            mine = None
            for ranks in layout:
                if len(ranks) == 1:
                    continue
                pg = dist.new_group(ranks)
                if me in ranks:
                    mine = kind(pg, siblings=layout)
            axes.append(mine)
        meshes[key] = tuple(axes)
    return meshes[key]


# ---------------------------------------------------------------------------
# Device accounting
# ---------------------------------------------------------------------------


def _available_devices() -> int:
    """The ranks of an initialized process group, else the local cards (at
    least one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def resolve_device_count(devices) -> int:
    """None -> 1, "auto" -> every available device (the ranks of an
    initialized process group, else the local cards), an int -> exactly
    that many; more than are present raises."""
    if devices is None:
        return 1
    avail = _available_devices()
    if devices == "auto":
        return avail
    if not _is_int(devices):
        raise TypeError(f"devices must be an int, 'auto' or None, got {devices!r}")
    n = int(devices)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if n > avail:
        raise ValueError(f"requested {n} devices, only {avail} present")
    return n


def population_device_count(num_clients: int,
                            devices: Optional[int] = None) -> int:
    """The largest device count <= ``devices`` (default: all available)
    that divides N, so every shard holds N/D clients."""
    if not _is_int(num_clients):
        raise TypeError(f"num_clients must be an int, got {num_clients!r}")
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    if devices is None:
        n_dev = _available_devices()
    else:
        if not _is_int(devices):
            raise TypeError(f"devices must be an int or None, got {devices!r} "
                            "(resolve 'auto' via resolve_device_count first)")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        n_dev = int(devices)
    while num_clients % n_dev:
        n_dev -= 1
    return n_dev


def factor_client_devices(num_clients: int, n_devices: int,
                          client_devices=None) -> int:
    """The clients-axis extent of a 2-D cells × clients mesh: an explicit
    request (it must divide both the device count and N) or the largest
    divisor of ``n_devices`` that divides N; at least 1."""
    if not _is_int(num_clients) or num_clients < 1:
        raise ValueError(f"num_clients must be a positive int, got {num_clients!r}")
    if client_devices is not None:
        if not _is_int(client_devices) or client_devices < 1:
            raise ValueError("client_devices must be a positive int or None, "
                             f"got {client_devices!r}")
        c = int(client_devices)
        if n_devices % c:
            raise ValueError(f"client_devices={c} must divide devices={n_devices} evenly")
        if num_clients % c:
            raise ValueError(f"client_devices={c} must divide num_clients="
                             f"{num_clients} evenly (equal client shards per device)")
        return c
    for c in range(n_devices, 0, -1):
        if n_devices % c == 0 and num_clients % c == 0:
            return c
    return 1


def pad_to_multiple(values: Sequence[int], multiple: int) -> list[int]:
    """Pad a list so its length divides ``multiple``, reusing its entries
    (the padded entries are computed and discarded)."""
    if not _is_int(multiple) or multiple < 1:
        raise ValueError(f"multiple must be a positive int, got {multiple!r}")
    values = list(values)
    if not values:
        raise ValueError("pad_to_multiple needs at least one value to pad from "
                         "(got an empty sequence)")
    pad = (-len(values)) % multiple
    return values + [values[i % len(values)] for i in range(pad)]


# ---------------------------------------------------------------------------
# Collective primitives
# ---------------------------------------------------------------------------


def local_slice(arr: torch.Tensor, axis: ClientAxis, n_local: int,
                dim: int = 0) -> torch.Tensor:
    """This rank's rows of an array held whole on every rank, along
    ``dim`` (the client axis: 0 for [N, ...], -1 for [G, N])."""
    return arr.narrow(dim, axis.rank * n_local, n_local)


def all_gather_axis(x: torch.Tensor, axis: ClientAxis, dim: int = 0) -> torch.Tensor:
    """Every shard's rows concatenated back to the global order along
    ``dim``."""
    return axis.all_gather(x, dim=dim)


def global_client_ids(axis: Optional[ClientAxis], n_local: int,
                      device) -> torch.Tensor:
    """This shard's global client ids [n_local] (int64): d·n_local + arange."""
    off = 0 if axis is None else axis.rank * n_local
    return off + torch.arange(n_local, dtype=torch.int64, device=device)


def top_k(v: torch.Tensor, k: int):
    """(values, idx) of the k largest entries of ``v`` [..., n] along the
    last axis, descending, ties lowest index first (``lax.top_k``'s
    order): a stable sort, since ``torch.topk`` promises no order among
    ties."""
    idx = torch.sort(v, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.take_along_dim(v, idx, dim=-1), idx


def shard_candidates(scores_local: torch.Tensor, k: int, offset):
    """Stage 1 of the tree: a shard's top min(k, n_local) scores and their
    global indices (a shard cannot hold more of the global top k)."""
    v, i = top_k(scores_local, min(k, scores_local.shape[-1]))
    return v, i + offset


def merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Stages 2 and 3: the top min(k, len) of gathered candidates, kept in
    gathered order on ties. Candidates gathered in shard order (or group
    order) keep the lower global index first, so ties resolve as one sort
    of the whole vector does."""
    v, pos = top_k(cand_v, min(k, cand_v.shape[-1]))
    return v, torch.take_along_dim(cand_i, pos, dim=-1)


def _auto_group_size(n_shards: int) -> int:
    """Default fan-in: the largest divisor of D not above sqrt(D) (flat
    below 16 shards)."""
    if n_shards < 16:
        return n_shards
    best = 1
    for g in range(2, int(n_shards ** 0.5) + 1):
        if n_shards % g == 0:
            best = g
    return best if best > 1 else n_shards


def _fan_in(n_shards: int, group_size: Optional[int]) -> Optional[int]:
    """The tree's group size, or None for the flat two-level pass."""
    g = group_size if group_size is not None else _auto_group_size(n_shards)
    if g <= 1 or g >= n_shards or n_shards % g:
        return None
    return g


def tree_top_k(scores: torch.Tensor, k: int, n_shards: int,
               group_size: Optional[int] = None) -> torch.Tensor:
    """:func:`hierarchical_top_k`'s tree in one process: the global top-k
    indices [..., k] of ``scores`` [..., N] split into ``n_shards``
    contiguous shards, each collective replaced by a concatenation in rank
    order."""
    n_local = scores.shape[-1] // n_shards
    cands = [shard_candidates(scores[..., d * n_local:(d + 1) * n_local], k,
                              d * n_local) for d in range(n_shards)]
    g = _fan_in(n_shards, group_size)
    if g is not None:
        kk = min(k, n_local)
        cands = [merge_candidates(torch.cat([v for v, _ in cands[b:b + g]], -1),
                                  torch.cat([i for _, i in cands[b:b + g]], -1),
                                  min(k, g * kk))
                 for b in range(0, n_shards, g)]
    return merge_candidates(torch.cat([v for v, _ in cands], -1),
                            torch.cat([i for _, i in cands], -1), k)[1]


def hierarchical_top_k(scores_local: torch.Tensor, k: int, axis: ClientAxis,
                       group_size: Optional[int] = None) -> torch.Tensor:
    """Global top-k indices [..., k] of a score vector sharded along
    ``axis`` (this rank's [..., n_local]), the same on every rank: each
    shard's candidates, gathered within contiguous groups of
    ``group_size`` shards and cut to the group's top min(k, g·kk), then
    gathered across the groups (each rank in one representative group)
    and cut to k. ``group_size`` None picks :func:`_auto_group_size`; 1,
    D or a non-divisor of D is the flat pass (one gather of every shard's
    candidates). Equal to one top-k of the whole vector, ties included.
    A leading [G] is G independent selections, gathered together."""
    n_local = scores_local.shape[-1]
    v, i = shard_candidates(scores_local, k, axis.rank * n_local)
    g = _fan_in(axis.size, group_size)
    if g is not None:
        mine, rep = axis.tree_groups(g)
        kk = min(k, n_local)
        v, i = merge_candidates(axis.all_gather(v, -1, group=mine),
                                axis.all_gather(i, -1, group=mine), min(k, g * kk))
        return merge_candidates(axis.all_gather(v, -1, group=rep),
                                axis.all_gather(i, -1, group=rep), k)[1]
    return merge_candidates(axis.all_gather(v, -1), axis.all_gather(i, -1), k)[1]


def distributed_top_k(scores_local: torch.Tensor, k: int, axis: ClientAxis,
                      n_global: int, group_size: Optional[int] = None):
    """``(mask [..., N], idx [..., k])`` of the global top k of a sharded
    score vector; the [N] mask is the winners' scatter (callers that must
    not hold O(N) use :func:`hierarchical_top_k`)."""
    idx = hierarchical_top_k(scores_local, k, axis, group_size=group_size)
    mask = torch.zeros(idx.shape[:-1] + (n_global,), dtype=torch.float32,
                       device=idx.device)
    return mask.scatter_(-1, idx, 1.0), idx


def project_simplex_sharded(v_local: torch.Tensor,
                            axis: Optional[ClientAxis] = None,
                            iters: int = 64) -> torch.Tensor:
    """Euclidean simplex projection of a row-sharded vector by bisection on
    the water level θ, the root of g(θ) = Σᵢ max(vᵢ − θ, 0) − 1: each rank
    sums its own rows and one ``psum`` an iteration gives g, with no gather
    and no sort. The bracket [vmax − 1, vmax] holds θ; ``iters`` halvings
    pin the support {vᵢ ≥ θ}, and θ is then recomputed from it in closed
    form, (Σ_supp vᵢ − 1)/|supp|, the sort-based formula. ``axis=None``
    runs the same program on one device. −inf rows project to 0. Each row
    of a leading [G] is projected alone, one ``psum`` an iteration for
    all of them."""
    v = v_local
    vmax = torch.amax(v, dim=-1, keepdim=True)
    if axis is not None:
        vmax = axis.pmax(vmax)
    lo, hi = vmax - 1.0, vmax
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = torch.sum(torch.clamp_min(v - mid, 0.0), dim=-1, keepdim=True)
        if axis is not None:
            s = axis.psum(s)
        above = s - 1.0 > 0
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    supp = v >= 0.5 * (lo + hi)
    cnt = torch.sum(supp.to(v.dtype), dim=-1, keepdim=True)
    ssum = torch.sum(torch.where(supp, v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device)),
                     dim=-1, keepdim=True)
    if axis is not None:
        both = axis.psum(torch.cat([cnt, ssum], dim=-1))
        cnt, ssum = both[..., :1], both[..., 1:]
    theta = (ssum - 1.0) / cnt
    return torch.clamp_min(v - theta, 0.0)


def _owned(idx: torch.Tensor, axis: ClientAxis, n_local: int):
    """(local row of each global index, clipped into range; whether this
    shard owns it)."""
    off = axis.rank * n_local
    lidx = torch.clamp(idx.long() - off, 0, n_local - 1)
    return lidx, (idx >= off) & (idx < off + n_local)


def take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``values``: [K, ...] from [N, ...] and [K], or
    each cell's own [G, K, ...] from [G, N, ...] and [G, K]."""
    if idx.dim() == 1:
        return values[idx]
    cells = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return values[cells, idx]


def _psum_owned(rows: torch.Tensor, owned: torch.Tensor, axis: ClientAxis):
    """psum of ``rows`` where owned and exact zeros elsewhere."""
    o = owned.reshape(owned.shape + (1,) * (rows.dim() - owned.dim()))
    return axis.psum(torch.where(o, rows, torch.zeros((), dtype=rows.dtype,
                                                      device=rows.device)))


def assemble_rows(values_local: torch.Tensor, idx: torch.Tensor,
                  axis: ClientAxis, n_local: int) -> torch.Tensor:
    """The rows [K, ...] at global indices ``idx`` of an array sharded by
    rows, on every rank: each index's owner contributes its row, the others
    exact zeros, and a psum adds them, so every slot equals a one-device
    gather bit for bit. With a leading [G] (``values_local`` [G, n_local,
    ...], ``idx`` [G, K]) each cell takes its own rows, in one psum."""
    lidx, owned = _owned(idx, axis, n_local)
    return _psum_owned(take_rows(values_local, lidx), owned, axis)


def merge_owned_rows(values: torch.Tensor, ids: torch.Tensor,
                     axis: ClientAxis) -> torch.Tensor:
    """``values`` [N, ...], held whole on every rank, with each row as its
    owner holds it: this rank owns the rows ``ids``, contributes them and
    exact zeros elsewhere, and a psum adds every rank's part. The ranks'
    ``ids`` must partition [0, N); a row then equals its owner's bit for
    bit."""
    owned = torch.zeros(values.shape[0], dtype=torch.bool,
                        device=values.device).index_fill_(0, ids.long(), True)
    return _psum_owned(values, owned, axis)


def assemble_batch_rows(shards_local: torch.Tensor, idx: torch.Tensor,
                        bidx: torch.Tensor, axis: ClientAxis,
                        n_local: int) -> torch.Tensor:
    """The batches [..., K, B, ...] of the clients ``idx`` [..., K] from
    client data sharded by rows (``shards_local`` [n_local, S, ...], shared
    by the cells); ``bidx`` [..., K, B] their in-shard sample indices,
    drawn per id on every rank."""
    lidx, owned = _owned(idx, axis, n_local)
    return _psum_owned(shards_local[lidx[..., None], bidx.long()], owned, axis)


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------


def control_sharded_cell_run(model, fl, method: str, axis: Optional[ClientAxis],
                             n_local: int, model_size: int, noise_free=None,
                             group_size: Optional[int] = None):
    """``run(point, draws, x, y, x_test, y_test) -> SimHistory`` of a group
    of G cells over this rank's client rows under the sharded control
    plane: ``point`` holds [G] knobs (``sweep.stack_points``) and
    ``draws`` is a ``draws.CellDraws`` of the cells' sources. The state is
    born local (λ, ``ChanState``, residuals for the rows' global ids) with
    a leading [G]. Every field of the history is [G, T]; its λ is this
    rank's rows on its last axis ([G, T, n_local] at
    ``record_lambda_every`` = 1, [G, ceil(T/E), n_local] at E > 1, () at
    0). ``axis=None`` is the one-device program."""
    from repro_torch.core.simulator import (SimHistory, init_sim_state,
                                            make_control_sharded_round_fn)

    def run(point, draws, x, y, x_test, y_test):
        ids = global_client_ids(axis, n_local, y.device)
        state = init_sim_state(model, fl, y.device, cells=draws.cells,
                               process=point.process, ids=ids, draws=draws)
        round_fn = make_control_sharded_round_fn(
            model, fl, (x, y, x_test, y_test), model_size, method, draws,
            noise_free=noise_free, axis=axis, topk_group_size=group_size)
        rows = []
        for t in range(fl.rounds):
            state, metrics = round_fn(point, state, t)
            rows.append(metrics)
        e = fl.record_lambda_every
        cols = {f: torch.stack([getattr(r, f) for r in rows], dim=1)
                for f in SimHistory._fields if f != "lam"}
        lam = (torch.stack([r.lam for r in rows], dim=1) if e == 1
               else () if e == 0 else state.lam_snaps)
        return SimHistory(lam=lam, **cols)

    return run


def check_divisible(num_clients: int, n_dev: int) -> None:
    if num_clients % n_dev:
        raise ValueError(
            f"population sharding needs N % devices == 0, got "
            f"N={num_clients}, devices={n_dev} "
            "(pick a count via population_device_count)")


def _local_rows(data, axis: Optional[ClientAxis], n_local: int, dev):
    """This rank's client rows of each array of ``data`` (sliced before
    they reach ``dev``)."""
    off = 0 if axis is None else axis.rank * n_local

    def rows(a):
        part = a[off:off + n_local]
        return (part if isinstance(part, torch.Tensor)
                else torch.as_tensor(np.asarray(part))).to(dev)

    return tuple(rows(a) for a in data)


def run_simulation_control_sharded(model, fl, data, axis: Optional[ClientAxis] = None,
                                   seed: Optional[int] = None,
                                   group_size: Optional[int] = None,
                                   draws=None, device=None):
    """Run T rounds of the sharded control plane with the population split
    along ``axis`` (None: one device, all N rows): each rank keeps only its
    N/D rows of the data (sliced before they reach ``device``; ``None``:
    the card), λ, ``ChanState`` and draws. ``draws`` is the run's
    ``draws.IdDraws`` (default ``HashDraws(seed)``, the same on every
    rank); ``group_size`` the top-k tree's fan-in. A sweep group of one
    cell. The λ history is gathered once at the end, so every rank returns
    the one-device run's ``SimHistory``: equal in every discrete field, and
    in the continuous ones up to the order of the cross-shard sums."""
    from repro_torch.core.draws import CellDraws, HashDraws
    from repro_torch.core.sweep import stack_points, sweep_point_from_config
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_size

    if fl.control_plane != "sharded":
        raise ValueError(
            "run_simulation_control_sharded needs control_plane='sharded' "
            f"(got {fl.control_plane!r}); the replicated plane shards its "
            "population through run_simulation_sharded")
    n_dev = 1 if axis is None else axis.size
    check_divisible(fl.num_clients, n_dev)
    dev = resolve_device(device)
    seed = fl.seed if seed is None else seed
    n_local = fl.num_clients // n_dev
    local = _local_rows(data, axis, n_local, dev)
    if draws is None:
        draws = HashDraws(seed, dev)
    point = stack_points([sweep_point_from_config(fl, dev)])
    model_size = tree_size(model.init(dev))
    run = control_sharded_cell_run(model, fl, fl.method, axis, n_local,
                                   model_size, group_size=group_size)
    hist = run(point, CellDraws([draws]), *local)
    hist = type(hist)(*(v if isinstance(v, tuple) else v[0] for v in hist))
    if axis is not None and not isinstance(hist.lam, tuple):
        hist = hist._replace(lam=axis.all_gather(hist.lam, dim=-1))
    return hist


def run_simulation_sharded(model, fl, data, axis: Optional[ClientAxis],
                           seed: Optional[int] = None, dense: bool = True,
                           draws=None, device=None, init_draws=None):
    """Run T rounds of the replicated control plane with the client
    population sharded along ``axis``, the reference's
    ``run_simulation_sharded``: every rank draws the full [N] control
    plane (channels, Gumbel noise, batch indices, the process's
    innovations; ``draws``/``init_draws`` as ``simulator.run_simulation``
    takes them) and runs selection, the energy ledger and λ replicated,
    while local SGD, the losses and the test eval run on its own N/D
    client rows and eq. (10) is a local partial sum + ``psum``
    (``*_psum_tree``). Dense/GCA rounds only, as in the reference
    (``dense`` must be True). ``axis=None`` is the one-device dense run,
    and an axis of one rank runs the sharded program over it (its psums
    over one rank); N % D ≠ 0 raises. Every rank returns the same
    history."""
    from repro_torch.core.simulator import run_replicated

    if fl.control_plane != "replicated":
        raise ValueError(
            "run_simulation_sharded runs the replicated control plane; "
            "control_plane='sharded' runs through "
            "run_simulation_control_sharded")
    if not dense:
        raise ValueError("population sharding runs the dense [N, model] "
                         "program (dense=True), as the reference does")
    n_dev = 1 if axis is None else axis.size
    check_divisible(fl.num_clients, n_dev)
    return run_replicated(model, fl, data, seed=seed, dense=True,
                          draws=draws, device=device, init_draws=init_draws,
                          axis=axis)
