"""The FL simulator (Algorithm 1); port of ``repro.core.simulator``.

One round, for an exact-K selection method (``selection.EXACT_K_METHODS``)
under any of the four uplink transports and the replicated control plane:

  1. channels from the round's normals, eq. (6) effective channel: drawn
     i.i.d. for a static scenario, or evolved by the temporal process
     (``core/dynamics.py``: Gauss-Markov fading, the shadow walk, the
     availability chain and the battery gate), whose schedulable clients
     are the only ones selection may pick;
  2. K clients by Gumbel-top-K (ties to the lowest index; a gated slot
     keeps its index and carries weight 0);
  3. only those K clients' batches are gathered and local SGD runs on a
     [K, ...] stack;
  4. eq. (10) is one pass over the raveled [K, P] buffer — a hand-written
     CUDA kernel on the card (``kernels/aircomp``), its plain version on the
     CPU: ``aircomp`` for analog and digital (digital with statically zero
     noise), ``quant_aircomp`` over the rounded deltas for quantized,
     ``sparse_aircomp`` over the compressed deltas for sparse, whose
     error-feedback residual rows are gathered from and scattered back to
     ``SimState.ef_resid`` by client id;
  5. the selected set's energy under the transport and the downlink
     broadcast (every listening client's receive), and for a temporal run
     the batteries depleted by both;
  6. the λ ascent step on K uniformly drawn (available) clients, with the
     losses evaluated only at the ascent and descent slots;
  7. the test accuracy of every client on the ``eval_every`` cadence.

GCA [10] runs the [N, model] path: one batch for every client, whose
gradients give the norms GCA's threshold reads and are reused as the
first SGD step; its scheduled count varies. A temporal or GCA round can
schedule nobody, and then keeps the global model (the empty-set guard);
exact-K static rounds always schedule K and skip the guard.

The round runs G independent cells at once (the sweep engine's points ×
seeds, ``core/sweep.py``): the reference vmaps its round over cells, the
port writes the cell axis out. Every tensor of the state (the temporal
process's ``chan_state`` too), the draws and the metrics leads with [G],
every knob of the ``SweepPoint`` is a [G] vector, and the batches and
residual rows are gathered per cell by ``sel_idx`` [G, K]. The eq. (10)
kernel still runs once per cell (G launches a round). ``run_simulation``
is a group of one cell.

``dense=True`` runs the [N, model] reference path instead (every client
descends and is masked; analog and digital aggregate per leaf and reach no
kernel, quantized and sparse run their flat pass over all N rows).
``lax.scan`` becomes a Python loop and ``vmap`` a written-out client axis.
Every random number comes from a ``RoundDraws`` per round and an
``InitDraws`` per run (``core/draws.py``). Scalars stay device tensors
through the round: nothing is copied to the host until the history is
read.

The sharded control plane (``control_plane="sharded"``,
:func:`make_control_sharded_round_fn`) is a round of its own: each device
holds only its rows of channels, availability, scores, λ and batch
indices, every draw addressed by global client id (an ``draws.IdDraws``
source; ``draws.CellDraws`` for a group of cells); exact-K selection is a
top-k tree over the shards, the K winners' rows are assembled by
ownership, the exact-K slot path runs on every device, and λ is projected
by bisection (``core/sharding.py``). It leads with the cell axis [G] as
the replicated round does, so a sweep group of the sharded plane is one
batched run and each collective moves the group's [G, ...] at once.
Without an axis it runs on one device with ``ids = arange(N)``, and
reaches the same eq. (10) kernels as the replicated plane's selected-K
path.

Population sharding of the replicated plane (``make_param_round_fn(...,
axis=)``, ``sharding.run_simulation_sharded``) keeps every [N] draw and
decision replicated and splits only the model-sized work over the ranks;
its eq. (10) is a psum of per-leaf partial sums and reaches no kernel, as
in the reference.
"""
from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aircomp import (aircomp_aggregate_stack_tree,
                                      aircomp_aggregate_tree, aircomp_psum_tree)
from repro_torch.core.channel import (draw_channels_scenario,
                                      draw_channels_scenario_ids,
                                      effective_channel)
from repro_torch.core.draws import (IdDraws, InitDraws, RoundDraws,
                                    round_draws, stack_draws, stack_init_draws)
from repro_torch.core.draws import init_draws as seeded_init_draws
from repro_torch.core.dro import lambda_ascent, lambda_summary
from repro_torch.core.dynamics import (commit_process, init_chan_state,
                                       init_chan_state_ids,
                                       process_from_config, step_process)
from repro_torch.core.selection import (EXACT_K_METHODS, availability_logits,
                                        client_gumbel, exact_k_scores,
                                        gumbel_topk, select_clients,
                                        select_clients_sparse)
from repro_torch.core.sharding import (all_gather_axis, assemble_batch_rows,
                                       assemble_rows, hierarchical_top_k,
                                       local_slice, project_simplex_sharded,
                                       take_rows, top_k)
from repro_torch.core.transport import (downlink_energy,
                                        quantized_aggregate_psum_tree,
                                        quantized_aggregate_stack_tree,
                                        require_ported, round_energy,
                                        sparse_aggregate_psum_tree,
                                        sparse_aggregate_stack_tree,
                                        sparse_k_coords, uplink_energy)
from repro_torch.models.logreg import SimModel
from repro_torch.utils.cells import per_cell
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names, tree_size


class SimState(NamedTuple):
    # every field leads with the cell axis [G] (under the sharded control
    # plane λ, ChanState and the residuals hold the device's own client
    # rows)
    w: dict              # global model {name: [G, ...]}
    lam: torch.Tensor    # [G, N] simplex weights
    energy: torch.Tensor  # [G] cumulative Joules
    eval_cache: Any = ()  # [G, 3] last (avg, worst, std) accuracy when eval_every > 1
    lam_snaps: Any = ()   # [G, ceil(T/E), N] λ snapshots when record_lambda_every = E > 1
    dl_energy: Any = ()   # [G] cumulative downlink Joules
    ef_resid: Any = ()    # [G, N, P] error-feedback residuals (sparse only)
    # the temporal process's dynamics.ChanState (fields [G, ...]); the
    # leaf-less () for a static scenario, whose round reads none
    chan_state: Any = ()


class SimHistory(NamedTuple):
    avg_acc: torch.Tensor    # [T]
    worst_acc: torch.Tensor  # [T]
    std_acc: torch.Tensor    # [T]
    energy: torch.Tensor     # [T] cumulative
    loss: torch.Tensor       # [T] mean train loss of the selected set
    num_scheduled: torch.Tensor  # [T]
    lam: Any                 # [T, N] at E=1, [ceil(T/E), N] at E>1, () at E=0
    avail_count: torch.Tensor  # [T]
    min_battery: torch.Tensor  # [T] (inf: static scenarios have no battery)
    lam_max: torch.Tensor      # [T]
    lam_entropy: torch.Tensor  # [T]
    lam_ess: torch.Tensor      # [T]
    dl_energy: torch.Tensor    # [T] cumulative downlink Joules


def mesh_size(mesh) -> int:
    """The device count of a mesh: a ``sharding.ClientAxis`` (or anything
    with a ``size``, an int or a method); None is one device."""
    if mesh is None:
        return 1
    size = mesh.size
    return int(size() if callable(size) else size)


def check_supported(fl: FLConfig) -> None:
    """Raise for a configuration whose code path the port does not carry."""
    if fl.control_plane not in ("replicated", "sharded"):
        raise ValueError(f"unknown control_plane {fl.control_plane!r}; "
                         "pick 'replicated' or 'sharded'")
    require_ported(fl.transport)
    if fl.method not in EXACT_K_METHODS + ("gca",):
        raise ValueError(f"unknown selection method {fl.method!r}")
    e = fl.record_lambda_every
    if not isinstance(e, int) or isinstance(e, bool) or e < 0:
        raise ValueError(f"record_lambda_every must be an int >= 0, got {e!r}")


def _gather_batches(x, y, cidx, bidx):
    """Batches of the selected clients only: [..., K, B, ...] from ``cidx``
    [..., K] and ``bidx`` [..., K, B], composed into one flat gather. Indices
    widen to int64 here, so the composed index cannot wrap at any population
    size or cell count."""
    n, s = y.shape
    flat = cidx.long()[..., None] * s + bidx.long()
    return x.reshape(n * s, *x.shape[2:])[flat], y.reshape(n * s)[flat]


def _all_batches(x, y, bidx):
    """One batch per client for all N clients: [..., N, B, ...] from
    ``bidx`` [..., N, B]."""
    rows = torch.arange(y.shape[0], device=y.device)[:, None]
    b = bidx.long()
    return x[rows, b], y[rows, b]


def _shared(w: dict) -> dict:
    """Each cell's model [G, ...] with a unit axis after the cell axis, so it
    broadcasts over that cell's clients or test shards."""
    return {name: w[name].unsqueeze(1) for name in leaf_names(w)}


def _record_lambda(fl: FLConfig, state: SimState, lam_new, t: int):
    """(λ history row, snapshot buffer) under ``record_lambda_every``. At
    E > 1 row t // E of the buffer is written in place on rounds t % E == 0."""
    e = fl.record_lambda_every
    if e == 1:
        return lam_new, state.lam_snaps
    if e > 1 and t % e == 0:
        state.lam_snaps[..., t // e, :] = lam_new
    return (), state.lam_snaps


def make_param_round_fn(model: SimModel, fl: FLConfig, data, model_size: int,
                        method: str, dense: bool = False,
                        noise_free: Optional[bool] = None, cells: int = 1,
                        axis=None):
    """Build ``round_fn(point, state, t, draws) -> (state, metrics)`` for a
    group of ``cells`` cells that share ``fl``'s structural fields
    (``sweep.STATIC_FIELDS``): ``point`` holds [G] knobs, ``state`` and
    ``draws`` lead with [G], and so does every field of the metrics.

    ``data`` = (x [N, S, ...], y [N, S], x_test [N, S_t, ...], y_test
    [N, S_t]) tensors on the run's device, shared by the cells.
    ``noise_free`` (default ``fl.noise_std == 0``) drops the eq. (10) noise
    statically; the sweep engine sets it only when every cell of the group
    is noise-free, and otherwise a quiet cell reads a zero AWGN row. GCA
    always runs the [N, model] path, whatever ``dense`` says.

    ``axis`` (population sharding, a ``sharding.ClientAxis`` of D ranks):
    ``data`` holds this rank's N/D client rows while ``fl.num_clients``
    stays the global N, and the round is the dense [N, model] program. The
    draws are the whole round's, the same on every rank, so selection,
    the energy ledger, the process and λ run replicated on [N] and agree
    bit for bit with the one-device run; local SGD, the losses and the
    test eval run on the local rows (the losses and accuracies
    all-gathered for λ and the statistics, GCA's gradient norms for its
    threshold), and eq. (10) is a local partial sum + ``psum``
    (``*_psum_tree``, no kernel, as in the reference). The sparse
    transport's residual rows (``SimState.ef_resid``) are the rank's own.
    """
    check_supported(fl)
    if fl.control_plane == "sharded":
        raise ValueError("the sharded control plane's round is "
                         "make_control_sharded_round_fn")
    x, y, x_test, y_test = data
    n, k_sched = fl.num_clients, fl.clients_per_round
    temporal, gca = fl.temporal, method == "gca"
    pop = axis is not None
    if pop and not (dense or gca):
        raise ValueError("population sharding runs the dense [N, model] "
                         "program; build with dense=True (the selected-K "
                         "path stays on one device)")
    dense = dense or gca
    n_local = y.shape[0]
    if n_local * (axis.size if pop else 1) != n:
        raise ValueError(f"{n_local} client rows on each of "
                         f"{axis.size if pop else 1} devices for N = {n}")
    off = axis.rank * n_local if pop else 0
    if noise_free is None:
        noise_free = fl.noise_std == 0
    scheme = fl.transport
    # the sparse transport's kept-coordinate count is static
    k_coords = (sparse_k_coords(fl.sparse_density, model_size)
                if scheme == "sparse" else None)
    dev = y.device
    f32 = dict(dtype=torch.float32, device=dev)
    cell_rows = torch.arange(cells, device=dev)[:, None]   # [G, 1]
    zeros_gn = torch.zeros((cells, n), **f32)
    n_g = torch.full((cells,), float(n), **f32)
    inf_g = torch.full((cells,), float("inf"), **f32)

    def rows(t, idx):
        """Rows ``idx`` [G, K] of each cell's ``t`` [G, N, ...]."""
        return t[cell_rows, idx]

    def mine(t, dim=-1):
        """This rank's client rows of a replicated [G, N, ...] tensor, the
        client axis at ``dim`` (all of it on one device)."""
        return t.narrow(dim, off, n_local) if pop else t

    def gathered(t):
        """[G, N] from every rank's [G, n_local]."""
        return all_gather_axis(t, axis, dim=-1) if pop else t

    def local_update(w, eta, xb, yb, g0=None):
        """``local_steps`` SGD steps from each cell's global model, for the
        cell's stack of clients: the first step broadcasts w [G, ...] to
        [G, C, ...]. ``g0``: the first step's gradients, already computed
        (GCA's probe)."""
        wc = _shared(w)
        for step in range(fl.local_steps):
            g = g0 if step == 0 and g0 is not None else model.grad(wc, xb, yb)
            wc = {name: wc[name] - per_cell(eta, g[name]) * g[name]
                  for name in leaf_names(g)}
        return wc

    def aggregate(tp, state: SimState, w_stack, weights, d, noise_std,
                  k_denom, idx):
        """Eq. (10) under the round's transport over the stacked updates of
        the clients ``idx`` [G, K] (None: all N, the dense path); returns
        ``(w_new, ef_resid)``. The quantized rounding uniforms and the
        sparse residuals are addressed by client id, so both paths round
        and compress every row identically."""
        z = None if noise_free else d.noise
        if pop:
            return aggregate_pop(tp, state, w_stack, mine(weights), d, z,
                                 noise_std, k_denom)
        if scheme == "quantized":
            if d.quant_uniform is None:
                raise ValueError("the quantized transport needs the round's "
                                 "RoundDraws.quant_uniform")
            u = d.quant_uniform if idx is None else rows(d.quant_uniform, idx)
            return quantized_aggregate_stack_tree(
                state.w, w_stack, weights, u, z, noise_std, tp.bits,
                k_denom), state.ef_resid
        if scheme == "sparse":
            resid = state.ef_resid if idx is None else rows(state.ef_resid, idx)
            w_new, resid = sparse_aggregate_stack_tree(
                state.w, w_stack, weights, z, noise_std, k_coords, k_denom,
                resid)
            if idx is None:
                return w_new, resid
            # idx rows are top-k outputs (unique within a cell), so the
            # scatter-back is exact; the residual buffer is the run's own
            # and is written in place
            state.ef_resid.index_put_((cell_rows, idx), resid)
            return w_new, state.ef_resid
        # digital decodes each upload exactly: statically no noise
        eff_noise = 0.0 if scheme == "digital" else noise_std
        if idx is None:
            return aircomp_aggregate_tree(w_stack, weights, z, eff_noise,
                                          k_denom), state.ef_resid
        return aircomp_aggregate_stack_tree(w_stack, weights, z, eff_noise,
                                            k_denom), state.ef_resid

    def aggregate_pop(tp, state: SimState, w_stack, mask_l, d, z, noise_std,
                      k_denom):
        """Eq. (10) over this rank's rows: a local partial sum and a psum
        (the quantized uniforms and the residuals are the rows' own)."""
        if scheme == "quantized":
            return quantized_aggregate_psum_tree(
                state.w, w_stack, mask_l, mine(d.quant_uniform, -2), z,
                noise_std, tp.bits, k_denom, axis), state.ef_resid
        if scheme == "sparse":
            return sparse_aggregate_psum_tree(
                state.w, w_stack, mask_l, z, noise_std, k_coords, k_denom,
                state.ef_resid, axis)
        eff_noise = 0.0 if scheme == "digital" else noise_std
        return aircomp_psum_tree(w_stack, mask_l, axis, z, eff_noise,
                                 k_denom), state.ef_resid

    def round_fn(point, state: SimState, t: int, d: RoundDraws):
        scen = point.scenario
        # ---- physical layer, eq. (6): i.i.d. block fading, or the temporal
        # process's tick, whose battery gate leaves out every client that
        # cannot pay this round's upload and receive
        if temporal:
            pstep = step_process(d, scen, point.process, state.chan_state,
                                 fl.num_subcarriers, model_size,
                                 scheme=scheme, tp=point.transport,
                                 dl_num_tx=k_sched)
            h, avail, eligible = pstep.h, pstep.avail, pstep.eligible
        else:
            h = effective_channel(draw_channels_scenario(
                d.chan_normal, d.shadow_normal, scen, fl.num_subcarriers))
            avail = eligible = None

        # ---- client selection (descent set D^(t))
        if gca:
            # one batch for every client: the probe batch is the descent
            # batch, and the probe gradients are SGD step 1
            xb, yb = _all_batches(x, y, mine(d.batch_idx, -2))
            grads0 = model.grad(_shared(state.w), xb, yb)
            gnorms = gathered(torch.sqrt(sum(
                torch.sum(torch.square(grads0[name]).flatten(2), dim=-1)
                for name in leaf_names(grads0))))
            mask = select_clients(method, d.sel_gumbel, state.lam, h, k_sched,
                                  avail=eligible, grad_norms=gnorms,
                                  gca=point.gca)
        elif dense:
            mask = select_clients(method, d.sel_gumbel, state.lam, h, k_sched,
                                  C=point.energy_C, avail=eligible)
        else:
            mask, sel_idx = select_clients_sparse(
                method, d.sel_gumbel, state.lam, h, k_sched, C=point.energy_C,
                avail=eligible)
        num_scheduled = torch.sum(mask, dim=-1)
        k_denom = torch.clamp_min(num_scheduled, 1.0)

        # ---- local updates + AirComp aggregation (eq. 10)
        eta = point.lr0 * point.lr_decay ** t
        noise_std = 0.0 if noise_free else scen.noise_std
        if dense:
            if not gca:
                xb, yb = _all_batches(x, y, mine(d.batch_idx, -2))
            w_stack = local_update(state.w, eta, xb, yb,
                                   g0=grads0 if gca else None)
            w_new, ef_resid = aggregate(point.transport, state, w_stack, mask,
                                        d, noise_std, k_denom, None)
        else:
            sel_mask = rows(mask, sel_idx)   # 0 at gated slots
            xb_s, yb_s = _gather_batches(x, y, sel_idx,
                                         rows(d.batch_idx, sel_idx))
            w_sel = local_update(state.w, eta, xb_s, yb_s)
            w_new, ef_resid = aggregate(point.transport, state, w_sel,
                                        sel_mask, d, noise_std, k_denom,
                                        sel_idx)
        if temporal or gca:
            # an empty scheduled set sends nothing over the air: the cell
            # keeps its model instead of eq. (10)'s noise-only sum
            sent = num_scheduled > 0
            w_new = {name: torch.where(per_cell(sent, w_new[name]),
                                       w_new[name], state.w[name])
                     for name in leaf_names(w_new)}

        # ---- energy ledger: the selected set's uplink + every listening
        # client's broadcast receive (exactly zero at the default
        # dl_rx_power = 0); a sparse broadcast is priced as the union of
        # the K payloads
        e_round = round_energy(scheme, point.transport, h, mask, model_size,
                               scen)
        recv_count = torch.sum(pstep.recv, dim=-1) if temporal else n_g
        e_dl = recv_count * downlink_energy(scheme, point.transport,
                                            model_size, scen, num_tx=k_sched)
        dl_energy = state.dl_energy + e_dl
        energy = state.energy + e_round + e_dl

        # ---- temporal carry: deplete the batteries, keep the process state
        if temporal:
            chan_state = commit_process(pstep, state.chan_state, mask)
            avail_count = torch.sum(eligible, dim=-1)
            min_battery = torch.amin(chan_state.battery, dim=-1)
        else:
            chan_state, avail_count, min_battery = state.chan_state, n_g, inf_g

        # ---- ascent step on λ (uniform K of the available clients, control
        # channel: no energy, no battery gate)
        asc_logits = zeros_gn if avail is None else (
            zeros_gn + availability_logits(avail))
        amask, asc_idx = gumbel_topk(d.asc_gumbel, asc_logits, k_sched)
        if temporal:
            amask = amask * avail
        w_cells = _shared(w_new)
        if dense:
            xab, yab = _all_batches(x, y, mine(d.asc_batch_idx, -2))
            losses = gathered(model.loss(w_cells, xab, yab))
            sel_loss = torch.sum(mask * losses, dim=-1) / k_denom
        else:
            # losses only at the ascent slots (λ update) and the descent
            # slots (selected-set loss metric), both on the ASCENT batches,
            # as the reference does
            xa, ya = _gather_batches(x, y, asc_idx, rows(d.asc_batch_idx, asc_idx))
            losses = zeros_gn.index_put((cell_rows, asc_idx),
                                        model.loss(w_cells, xa, ya))
            xd, yd = _gather_batches(x, y, sel_idx, rows(d.asc_batch_idx, sel_idx))
            sel_loss = torch.sum(sel_mask * model.loss(w_cells, xd, yd),
                                 dim=-1) / k_denom
        lam_new = lambda_ascent(state.lam, losses, amask, point.ascent_lr)
        lam_max, lam_entropy, lam_ess = lambda_summary(lam_new)
        lam_hist, lam_snaps = _record_lambda(fl, state, lam_new, t)

        # ---- metrics: the N-client test eval on the eval_every cadence
        if t % fl.eval_every == 0:
            accs = gathered(model.accuracy(w_cells, x_test, y_test))   # [G, N]
            stats = torch.stack([accs.mean(dim=-1), accs.amin(dim=-1),
                                 accs.std(dim=-1, correction=0)], dim=-1)
        else:
            stats = state.eval_cache
        eval_cache = () if fl.eval_every == 1 else stats
        metrics = SimHistory(
            avg_acc=stats[:, 0], worst_acc=stats[:, 1], std_acc=stats[:, 2],
            energy=energy, loss=sel_loss, num_scheduled=num_scheduled,
            lam=lam_hist, avail_count=avail_count, min_battery=min_battery,
            lam_max=lam_max, lam_entropy=lam_entropy, lam_ess=lam_ess,
            dl_energy=dl_energy)
        return SimState(w_new, lam_new, energy, eval_cache, lam_snaps,
                        dl_energy, ef_resid, chan_state), metrics

    return round_fn


def _batch_indices_ids(stream, ids: torch.Tensor, shard_size: int,
                       batch_size: int) -> torch.Tensor:
    """[n, B] int32 in-shard sample indices of the clients ``ids``, row c
    drawn from ``stream`` at ids[c] alone: a shard draws its own rows, and
    the slot path draws just the K winners' rows, with the same values."""
    return stream.randint(ids, (batch_size,), shard_size)


def make_control_sharded_round_fn(model: SimModel, fl: FLConfig, data,
                                  model_size: int, method: str,
                                  draws,
                                  noise_free: Optional[bool] = None,
                                  axis=None,
                                  topk_group_size: Optional[int] = None):
    """Build ``round_fn(point, state, t) -> (state, metrics)`` of the
    sharded control plane for a group of G cells: ``draws`` is the group's
    ``draws.CellDraws`` (G = ``draws.cells``; round t's randomness is
    ``draws.round(t)``, every draw [G, ...], addressed by global client
    id), ``point`` holds [G] knobs and ``state`` this device's rows with a
    leading [G] (``init_sim_state(cells=G, ids=..., draws=draws)``).

    ``data`` = (x, y, x_test, y_test) hold this device's n_rows = N/D
    clients (all N without an ``axis``, a ``sharding.ClientAxis``), shared
    by the cells. Exact-K methods score their rows, select by the top-k
    tree (``sharding.hierarchical_top_k``, fan-in ``topk_group_size``),
    assemble the K winners' batches, channels and residual rows by
    ownership, and run local SGD and eq. (10) on the [G, K] slots on every
    device (the transport's kernel on the card, once a cell); the ascent
    set is a second tree top-k over per-id Gumbel scores, its losses and
    the descent losses taken at the slots and scattered back to the
    owners' rows. GCA runs its [N, model] probe on the local rows and
    gathers the O(N) norms, channels and gates for its population-wide
    threshold (the one O(N) collective of the round); on a mesh its
    eq. (10) is the local partial sum + psum of ``*_psum_tree``. λ is
    projected by the psum bisection and the test statistics are psums of
    local rows, so no other collective moves O(N) values. Every
    collective moves the whole group's [G, ...] at once.
    """
    cells = draws.cells
    x, y, x_test, y_test = data
    n, kk = fl.num_clients, fl.clients_per_round
    shard, b = y.shape[1], fl.batch_size
    if noise_free is None:
        noise_free = fl.noise_std == 0
    scheme = fl.transport
    require_ported(scheme)
    gca = method == "gca"
    if not gca and method not in EXACT_K_METHODS:
        raise ValueError(f"unknown selection method {method!r}")
    n_rows = y.shape[0]
    n_shards = 1 if axis is None else axis.size
    if n_rows * n_shards != n:
        raise ValueError(f"{n_rows} client rows on each of {n_shards} devices "
                         f"for N = {n}")
    temporal = fl.temporal
    k_coords = (sparse_k_coords(fl.sparse_density, model_size)
                if scheme == "sparse" else None)
    dev = y.device
    f32 = dict(dtype=torch.float32, device=dev)
    off = 0 if axis is None else axis.rank * n_rows
    ids = off + torch.arange(n_rows, dtype=torch.int64, device=dev)
    ones_k = torch.ones((cells, kk), **f32)
    zeros_rows = torch.zeros((cells, n_rows), **f32)
    n_g = torch.full((cells,), float(n), **f32)
    inf_g = torch.full((cells,), float("inf"), **f32)

    def psum(v):
        return v if axis is None else axis.psum(v)

    def local_update(w, eta, xb, yb, g0=None):
        """``local_steps`` SGD steps from each cell's global model for its
        stack of clients [G, C, B, ...]; ``g0``: the first step's
        gradients (GCA's probe)."""
        wc = _shared(w)
        for step in range(fl.local_steps):
            g = g0 if step == 0 and g0 is not None else model.grad(wc, xb, yb)
            wc = {name: wc[name] - per_cell(eta, g[name]) * g[name]
                  for name in leaf_names(g)}
        return wc

    def topk_idx(scores):
        if axis is None:
            return top_k(scores, kk)[1]
        return hierarchical_top_k(scores, kk, axis, group_size=topk_group_size)

    def slot_vals(vals, idx):
        """Each cell's vals[idx] across the shards (by ownership on a
        mesh)."""
        if axis is None:
            return take_rows(vals, idx)
        return assemble_rows(vals, idx, axis, n_rows)

    def slot_batches(arr, idx, bidx):
        if axis is None:
            return arr[idx[..., None], bidx.long()]
        return assemble_batch_rows(arr, idx, bidx, axis, n_rows)

    def owned_rows(idx):
        lidx = torch.clamp(idx - off, 0, n_rows - 1)
        return lidx, (idx >= off) & (idx < off + n_rows)

    def scatter_slots(idx, wvals):
        """[G, K] slot values added into this device's [G, n_rows] (owned
        slots only; the others add exact zeros)."""
        lidx, owned = owned_rows(idx)
        return zeros_rows.scatter_add(-1, lidx, torch.where(
            owned, wvals, torch.zeros((), **f32)))

    def round_fn(point, state: SimState, t: int):
        d = draws.round(t)
        scen = point.scenario
        # ---- physical layer: per-id draws of this device's rows only
        if temporal:
            pstep = step_process(d.chan, scen, point.process, state.chan_state,
                                 fl.num_subcarriers, model_size, scheme=scheme,
                                 tp=point.transport, dl_num_tx=kk, ids=ids)
            h, avail, eligible = pstep.h, pstep.avail, pstep.eligible
        else:
            h = effective_channel(draw_channels_scenario_ids(
                d.chan, scen, ids, fl.num_subcarriers))
            avail = eligible = None
        eta = point.lr0 * point.lr_decay ** t
        noise_std = 0.0 if noise_free else scen.noise_std
        z = None if noise_free else d.awgn(model_size)

        if gca:
            # the [N, model] probe on local rows; its batch is the descent
            # batch and its gradients SGD step 1
            xb, yb = _all_batches(x, y, _batch_indices_ids(d.batch, ids, shard, b))
            grads0 = model.grad(_shared(state.w), xb, yb)
            gnorms = torch.sqrt(sum(
                torch.sum(torch.square(grads0[name]).flatten(2), dim=-1)
                for name in leaf_names(grads0)))
            if axis is None:
                gnorms_f, h_f, elig_f = gnorms, h, eligible
            else:
                # the threshold's mean and median are population-wide: the
                # round's one O(N) gather
                gnorms_f = all_gather_axis(gnorms, axis, dim=-1)
                h_f = all_gather_axis(h, axis, dim=-1)
                elig_f = (all_gather_axis(eligible, axis, dim=-1)
                          if temporal else None)
            mask_f = select_clients("gca", None, torch.zeros_like(h_f), h_f, kk,
                                    avail=elig_f, grad_norms=gnorms_f,
                                    gca=point.gca)
            mask_l = mask_f if axis is None else local_slice(mask_f, axis,
                                                             n_rows, dim=-1)
            num_sched = torch.sum(mask_f, dim=-1)
            k_denom = torch.clamp_min(num_sched, 1.0)
            w_stack = local_update(state.w, eta, xb, yb, g0=grads0)
            ef_new = state.ef_resid
            if scheme == "quantized":
                u = d.noise.fold(7).uniform(ids, (model_size,))
                if axis is None:
                    w_new = quantized_aggregate_stack_tree(
                        state.w, w_stack, mask_l, u, z, noise_std,
                        point.transport.bits, k_denom)
                else:
                    w_new = quantized_aggregate_psum_tree(
                        state.w, w_stack, mask_l, u, z, noise_std,
                        point.transport.bits, k_denom, axis)
            elif scheme == "sparse":
                # residual rows stay on their device
                if axis is None:
                    w_new, ef_new = sparse_aggregate_stack_tree(
                        state.w, w_stack, mask_l, z, noise_std, k_coords,
                        k_denom, state.ef_resid)
                else:
                    w_new, ef_new = sparse_aggregate_psum_tree(
                        state.w, w_stack, mask_l, z, noise_std, k_coords,
                        k_denom, state.ef_resid, axis)
            else:
                eff_noise = 0.0 if scheme == "digital" else noise_std
                if axis is None:
                    w_new = aircomp_aggregate_tree(w_stack, mask_l, z, eff_noise,
                                                   k_denom)
                else:
                    w_new = aircomp_psum_tree(w_stack, mask_l, axis, z,
                                              eff_noise, k_denom)
            e_round = psum(round_energy(scheme, point.transport, h, mask_l,
                                        model_size, scen))
        else:
            # ---- exact-K: per-id scores -> top-k tree -> slot path
            scores = exact_k_scores(method, d.sel, state.lam, h,
                                    C=point.energy_C, avail=eligible, ids=ids)
            sel_idx = topk_idx(scores)
            # a gated slot keeps its index and carries weight 0
            sel_w = slot_vals(eligible, sel_idx) if temporal else ones_k
            num_sched = torch.sum(sel_w, dim=-1)
            k_denom = torch.clamp_min(num_sched, 1.0)
            mask_l = scatter_slots(sel_idx, sel_w)
            bidx = _batch_indices_ids(d.batch, sel_idx, shard, b)
            w_sel = local_update(state.w, eta, slot_batches(x, sel_idx, bidx),
                                 slot_batches(y, sel_idx, bidx))
            ef_new = state.ef_resid
            if scheme == "quantized":
                w_new = quantized_aggregate_stack_tree(
                    state.w, w_sel, sel_w,
                    d.noise.fold(7).uniform(sel_idx, (model_size,)), z,
                    noise_std, point.transport.bits, k_denom)
            elif scheme == "sparse":
                # the winners' residual rows come by ownership, compress on
                # every device, and go back to their owners' rows only (a
                # clipped index of a row not owned adds an exact zero and
                # no hit; owned top-k indices are unique within a cell)
                w_new, resid = sparse_aggregate_stack_tree(
                    state.w, w_sel, sel_w, z, noise_std, k_coords, k_denom,
                    slot_vals(state.ef_resid, sel_idx))
                lidx, owned = owned_rows(sel_idx)
                cell = torch.arange(cells, device=dev)[:, None]
                upd = torch.zeros_like(state.ef_resid).index_put_(
                    (cell, lidx), torch.where(owned[..., None], resid,
                                              torch.zeros((), **f32)),
                    accumulate=True)
                hit = zeros_rows.scatter_add(-1, lidx, owned.to(torch.float32))
                ef_new = torch.where(hit[..., None] > 0, upd, state.ef_resid)
            else:
                w_new = aircomp_aggregate_stack_tree(
                    w_sel, sel_w, z, 0.0 if scheme == "digital" else noise_std,
                    k_denom)
            # the ledger as a [K]-slot sum: the same shape and order on a
            # mesh and on one device
            e_round = torch.sum(sel_w * uplink_energy(
                scheme, point.transport, slot_vals(h, sel_idx), model_size,
                scen), dim=-1)
        if temporal or gca:
            # an empty scheduled set sends nothing: the cell keeps its model
            sent = num_sched > 0
            w_new = {name: torch.where(per_cell(sent, w_new[name]),
                                       w_new[name], state.w[name])
                     for name in leaf_names(w_new)}

        # ---- downlink: every listening client pays the broadcast receive
        recv_count = psum(torch.sum(pstep.recv, dim=-1)) if temporal else n_g
        e_dl = recv_count * downlink_energy(scheme, point.transport, model_size,
                                            scen, num_tx=kk)
        dl_energy = state.dl_energy + e_dl
        energy = state.energy + e_round + e_dl

        # ---- temporal carry (local rows)
        if temporal:
            chan_state = commit_process(pstep, state.chan_state, mask_l)
            avail_count = psum(torch.sum(eligible, dim=-1))
            min_battery = torch.amin(chan_state.battery, dim=-1)
            if axis is not None:
                min_battery = axis.pmin(min_battery)
        else:
            chan_state, avail_count, min_battery = state.chan_state, n_g, inf_g

        # ---- ascent on λ: uniform K of the available clients, per-id
        # Gumbel scores, the top-k tree again
        ascores = zeros_rows + availability_logits(avail) + client_gumbel(d.asel, ids)
        asc_idx = topk_idx(ascores)
        a_gate = slot_vals(avail, asc_idx) if temporal else ones_k
        w_cells = _shared(w_new)
        if gca:
            xab, yab = _all_batches(x, y, _batch_indices_ids(d.abatch, ids, shard, b))
            losses = model.loss(w_cells, xab, yab)
            asc_contrib = scatter_slots(asc_idx, a_gate) * losses
            sel_loss = psum(torch.sum(mask_l * losses, dim=-1)) / k_denom
        else:
            # losses only where they are read: the ascent and descent slots
            bidx_a = _batch_indices_ids(d.abatch, asc_idx, shard, b)
            asc_losses = model.loss(w_cells, slot_batches(x, asc_idx, bidx_a),
                                    slot_batches(y, asc_idx, bidx_a))
            asc_contrib = scatter_slots(asc_idx, a_gate * asc_losses)
            bidx_d = _batch_indices_ids(d.abatch, sel_idx, shard, b)
            sel_loss = torch.sum(sel_w * model.loss(
                w_cells, slot_batches(x, sel_idx, bidx_d),
                slot_batches(y, sel_idx, bidx_d)), dim=-1) / k_denom
        lam_new = project_simplex_sharded(
            state.lam + per_cell(point.ascent_lr, state.lam) * asc_contrib,
            axis=axis)
        lam_max, lam_entropy, lam_ess = lambda_summary(lam_new, axis=axis)
        lam_hist, lam_snaps = _record_lambda(fl, state, lam_new, t)

        # ---- metrics: the test statistics as sums of local rows
        if t % fl.eval_every == 0:
            accs = model.accuracy(w_cells, x_test, y_test)   # [G, n_rows]
            if axis is None:
                stats = torch.stack([accs.mean(dim=-1), accs.amin(dim=-1),
                                     accs.std(dim=-1, correction=0)], dim=-1)
            else:
                mean = axis.psum(torch.sum(accs, dim=-1)) / n
                var = axis.psum(torch.sum(torch.square(accs - mean[:, None]),
                                          dim=-1)) / n
                stats = torch.stack([mean, axis.pmin(torch.amin(accs, dim=-1)),
                                     torch.sqrt(var)], dim=-1)
        else:
            stats = state.eval_cache
        eval_cache = () if fl.eval_every == 1 else stats
        metrics = SimHistory(
            avg_acc=stats[:, 0], worst_acc=stats[:, 1], std_acc=stats[:, 2],
            energy=energy, loss=sel_loss, num_scheduled=num_sched,
            lam=lam_hist, avail_count=avail_count, min_battery=min_battery,
            lam_max=lam_max, lam_entropy=lam_entropy, lam_ess=lam_ess,
            dl_energy=dl_energy)
        return SimState(w_new, lam_new, energy, eval_cache, lam_snaps,
                        dl_energy, ef_new, chan_state), metrics

    return round_fn


def init_sim_state(model: SimModel, fl: FLConfig, device=None,
                   cells: int = 1, process=None,
                   init: Optional[InitDraws] = None, ids=None,
                   draws=None) -> SimState:
    """Initial state of ``cells`` cells: the model's init, uniform λ, zero
    energy (and zero error-feedback residuals for the sparse transport), on
    ``device`` (``None``: the card). Every field leads with [cells].

    A temporal run also starts its process (``dynamics.init_chan_state``)
    from ``init`` (``InitDraws`` with [cells] leading) and ``process``, the
    cells' ``ChannelProcess`` (its ``battery_init`` a [cells] vector or a
    scalar; default: ``fl``'s).

    Under the sharded control plane the state holds the rows of the global
    client ids ``ids`` (default: all N): λ, the residuals and a temporal
    run's process, whose fading normals come per id from ``draws.init()``
    (``draws`` the cells' ``draws.CellDraws``), so a shard's rows equal
    those rows of the whole state."""
    device = resolve_device(device)
    if fl.control_plane == "sharded":
        return _init_rows(model, fl, device, cells, process, ids, draws)
    if ids is not None:
        raise ValueError("ids is a control_plane='sharded' argument; the "
                         "replicated plane initializes all N rows")
    chan_state = ()
    if fl.temporal:
        if init is None or init.fast_normal is None:
            raise ValueError("a temporal run's state needs its InitDraws")
        if process is None:
            process = process_from_config(fl, device)
        chan_state = init_chan_state(process, init.fast_normal.to(device))
    e = fl.record_lambda_every
    n = fl.num_clients
    f32 = dict(dtype=torch.float32, device=device)
    w0 = model.init(device)
    w = {name: leaf.expand(cells, *leaf.shape).clone()
         for name, leaf in w0.items()}
    return SimState(
        w=w,
        lam=torch.full((cells, n), 1.0 / n, **f32),
        energy=torch.zeros((cells,), **f32),
        eval_cache=() if fl.eval_every == 1 else torch.zeros((cells, 3), **f32),
        lam_snaps=(() if e in (0, 1)
                   else torch.zeros((cells, (fl.rounds + e - 1) // e, n), **f32)),
        dl_energy=torch.zeros((cells,), **f32),
        ef_resid=(torch.zeros((cells, n, tree_size(w0)), **f32)
                  if fl.transport == "sparse" else ()),
        chan_state=chan_state,
    )


def _init_rows(model: SimModel, fl: FLConfig, device, cells: int, process,
               ids, draws) -> SimState:
    """The sharded control plane's initial state of ``cells`` cells' rows
    ``ids``; a temporal state draws from the group's ``draws.CellDraws``."""
    if ids is None:
        ids = torch.arange(fl.num_clients, dtype=torch.int64, device=device)
    n_rows = ids.shape[0]
    chan_state = ()
    if fl.temporal:
        if draws is None or getattr(draws, "cells", None) != cells:
            raise ValueError(f"a temporal run's state needs the CellDraws of "
                             f"its {cells} cells")
        if process is None:
            process = process_from_config(fl, device)
        chan_state = init_chan_state_ids(process, draws.init(), ids,
                                         fl.num_subcarriers, fl.flat_fading)
    e = fl.record_lambda_every
    f32 = dict(dtype=torch.float32, device=device)
    w0 = model.init(device)
    return SimState(
        w={name: leaf.expand(cells, *leaf.shape).clone()
           for name, leaf in w0.items()},
        lam=torch.full((cells, n_rows), 1.0 / fl.num_clients, **f32),
        energy=torch.zeros((cells,), **f32),
        eval_cache=() if fl.eval_every == 1 else torch.zeros((cells, 3), **f32),
        lam_snaps=(() if e in (0, 1)
                   else torch.zeros((cells, (fl.rounds + e - 1) // e, n_rows),
                                    **f32)),
        dl_energy=torch.zeros((cells,), **f32),
        ef_resid=(torch.zeros((cells, n_rows, tree_size(w0)), **f32)
                  if fl.transport == "sparse" else ()),
        chan_state=chan_state,
    )


def run_rounds(round_fn, point, state: SimState, fl: FLConfig,
               draws: Iterable[RoundDraws]) -> SimHistory:
    """Run ``fl.rounds`` rounds of ``round_fn`` from ``state`` on batched
    ``draws`` (one ``RoundDraws`` a round, fields [G, ...]); the history's
    fields are [G, T, ...] (λ [G, ceil(T/E), N] at E > 1, () at E = 0)."""
    it = iter(draws)
    rows = []
    for t in range(fl.rounds):
        d = next(it, None)
        if d is None:
            raise ValueError(f"draws ran out after {t} of {fl.rounds} rounds")
        state, metrics = round_fn(point, state, t, d)
        rows.append(metrics)
    e = fl.record_lambda_every
    cols = {f: torch.stack([getattr(r, f) for r in rows], dim=1)
            for f in SimHistory._fields if f != "lam"}
    lam = torch.stack([r.lam for r in rows], dim=1) if e == 1 else (
        () if e == 0 else state.lam_snaps)
    return SimHistory(lam=lam, **cols)


def run_simulation(model: SimModel, fl: FLConfig, data,
                   seed: Optional[int] = None, dense: bool = False, mesh=None,
                   draws=None, device=None,
                   init_draws: Optional[InitDraws] = None) -> SimHistory:
    """Run T rounds of Algorithm 1 (or a baseline, per ``fl.method``): the
    batched round with one cell, its history squeezed to [T, ...].

    ``data`` = (x, y, x_test, y_test) stacked per client, numpy or tensors.
    ``draws``: an iterable of T ``RoundDraws`` (e.g. the reference's numbers
    in a test); by default ``draws.round_draws`` makes them on the run's
    device from ``seed`` (``fl.seed`` if None). ``init_draws``: the run's
    ``InitDraws`` (a temporal run's initial fading normals); by default
    ``draws.init_draws`` from the same seed. ``device=None`` is the CUDA
    card, and raises when there is none.

    ``mesh`` (a ``sharding.ClientAxis`` of more than one rank; a mesh of
    one is a no-op) shards the client population: every rank passes all
    the data and the same arguments, and gets the same history. Under the
    replicated plane that is ``sharding.run_simulation_sharded``, the
    dense [N, model] program with eq. (10) as a psum. Under
    ``control_plane="sharded"``
    (``sharding.run_simulation_control_sharded``) ``draws`` is the run's
    ``draws.IdDraws`` (default ``HashDraws(seed)``), which gives the
    initial draws too, and each rank keeps only its rows.
    """
    dev = resolve_device(device)
    check_supported(fl)
    seed = fl.seed if seed is None else seed
    axis = mesh if mesh_size(mesh) > 1 else None
    if fl.control_plane == "sharded":
        from repro_torch.core.sharding import run_simulation_control_sharded
        if dense:
            raise ValueError("control_plane='sharded' has one program a "
                             "method (its slot path); dense=True is the "
                             "replicated plane's [N, model] path")
        if init_draws is not None:
            raise ValueError("under control_plane='sharded' the IdDraws "
                             "source gives the initial draws")
        if draws is not None and not isinstance(draws, IdDraws):
            raise TypeError("control_plane='sharded' takes an IdDraws "
                            f"source as draws, got {type(draws).__name__}")
        return run_simulation_control_sharded(model, fl, data, axis, seed=seed,
                                              draws=draws, device=dev)
    if axis is not None:
        from repro_torch.core.sharding import run_simulation_sharded
        return run_simulation_sharded(model, fl, data, axis, seed=seed,
                                      draws=draws, device=dev,
                                      init_draws=init_draws)
    return run_replicated(model, fl, data, seed, dense, draws, dev, init_draws)


def run_replicated(model: SimModel, fl: FLConfig, data, seed: Optional[int],
                   dense: bool, draws, device, init_draws: Optional[InitDraws],
                   axis=None) -> SimHistory:
    """:func:`run_simulation` of the replicated control plane, on one
    device or, with ``axis``, population-sharded over its ranks (``dense``
    then True): each rank slices its client rows of ``data`` and draws
    the whole round's [N] draws."""
    from repro_torch.core.sweep import stack_points, sweep_point_from_config

    dev = resolve_device(device)
    seed = fl.seed if seed is None else seed
    n_local = fl.num_clients // (1 if axis is None else axis.size)
    off = 0 if axis is None else axis.rank * n_local
    shard_size = torch.as_tensor(data[1]).shape[1]
    data = tuple(torch.as_tensor(a)[off:off + n_local].to(dev) for a in data)
    point = stack_points([sweep_point_from_config(fl, dev)])
    if init_draws is None:
        init_draws = seeded_init_draws(seed, fl, dev)
    state = init_sim_state(model, fl, dev, process=point.process,
                           init=stack_init_draws([init_draws.to(dev)]))
    if axis is not None and fl.transport == "sparse":
        # the residual rows live with their clients
        state = state._replace(ef_resid=state.ef_resid[:, off:off + n_local])
    model_size = tree_size(state.w)   # one cell
    noise_free = fl.noise_std == 0
    round_fn = make_param_round_fn(model, fl, data, model_size, fl.method,
                                   dense=dense, noise_free=noise_free,
                                   axis=axis)
    if draws is None:
        draws = round_draws(seed, fl, model_size, shard_size, dev)
    batched = (stack_draws([d.to(dev)], not noise_free, model_size)
               for d in draws)
    hist = run_rounds(round_fn, point, state, fl, batched)
    return SimHistory(*(v if isinstance(v, tuple) else v[0] for v in hist))
