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

Not ported yet, and raising ``NotImplementedError``: the sharded control
plane and meshes (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aircomp import (aircomp_aggregate_stack_tree,
                                      aircomp_aggregate_tree)
from repro_torch.core.channel import draw_channels_scenario, effective_channel
from repro_torch.core.draws import (InitDraws, RoundDraws, round_draws,
                                    stack_draws, stack_init_draws)
from repro_torch.core.draws import init_draws as seeded_init_draws
from repro_torch.core.dro import lambda_ascent, lambda_summary
from repro_torch.core.dynamics import (commit_process, init_chan_state,
                                       process_from_config, step_process)
from repro_torch.core.selection import (EXACT_K_METHODS, availability_logits,
                                        gumbel_topk, select_clients,
                                        select_clients_sparse)
from repro_torch.core.transport import (downlink_energy,
                                        quantized_aggregate_stack_tree,
                                        require_ported, round_energy,
                                        sparse_aggregate_stack_tree,
                                        sparse_k_coords)
from repro_torch.models.logreg import SimModel
from repro_torch.utils.cells import per_cell
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names, tree_size


class SimState(NamedTuple):
    # every field leads with the cell axis [G]
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


def check_supported(fl: FLConfig, mesh=None) -> None:
    """Raise for a configuration whose code path the port does not carry."""
    if mesh is not None or fl.control_plane == "sharded":
        raise NotImplementedError(
            "meshes and the sharded control plane are not ported yet "
            "(ROADMAP Queue 1 item 9)")
    if fl.control_plane != "replicated":
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
        state.lam_snaps[:, t // e] = lam_new
    return (), state.lam_snaps


def make_param_round_fn(model: SimModel, fl: FLConfig, data, model_size: int,
                        method: str, dense: bool = False,
                        noise_free: Optional[bool] = None, cells: int = 1):
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
    """
    check_supported(fl)
    x, y, x_test, y_test = data
    n, k_sched = fl.num_clients, fl.clients_per_round
    temporal, gca = fl.temporal, method == "gca"
    dense = dense or gca
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
            xb, yb = _all_batches(x, y, d.batch_idx)
            grads0 = model.grad(_shared(state.w), xb, yb)
            gnorms = torch.sqrt(sum(
                torch.sum(torch.square(grads0[name]).flatten(2), dim=-1)
                for name in leaf_names(grads0)))
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
                xb, yb = _all_batches(x, y, d.batch_idx)
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
            xab, yab = _all_batches(x, y, d.asc_batch_idx)
            losses = model.loss(w_cells, xab, yab)
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
            accs = model.accuracy(w_cells, x_test, y_test)   # [G, N]
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


def init_sim_state(model: SimModel, fl: FLConfig, device=None,
                   cells: int = 1, process=None,
                   init: Optional[InitDraws] = None) -> SimState:
    """Initial state of ``cells`` cells: the model's init, uniform λ, zero
    energy (and zero error-feedback residuals for the sparse transport), on
    ``device`` (``None``: the card). Every field leads with [cells].

    A temporal run also starts its process (``dynamics.init_chan_state``)
    from ``init`` (``InitDraws`` with [cells] leading) and ``process``, the
    cells' ``ChannelProcess`` (its ``battery_init`` a [cells] vector or a
    scalar; default: ``fl``'s)."""
    device = resolve_device(device)
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
    """
    from repro_torch.core.sweep import stack_points, sweep_point_from_config

    dev = resolve_device(device)
    check_supported(fl, mesh)
    seed = fl.seed if seed is None else seed
    data = tuple(torch.as_tensor(a).to(dev) for a in data)
    point = stack_points([sweep_point_from_config(fl, dev)])
    if init_draws is None:
        init_draws = seeded_init_draws(seed, fl, dev)
    state = init_sim_state(model, fl, dev, process=point.process,
                           init=stack_init_draws([init_draws.to(dev)]))
    model_size = tree_size(state.w)   # one cell
    noise_free = fl.noise_std == 0
    round_fn = make_param_round_fn(model, fl, data, model_size, fl.method,
                                   dense=dense, noise_free=noise_free)
    if draws is None:
        draws = round_draws(seed, fl, model_size, data[1].shape[1], dev)
    batched = (stack_draws([d.to(dev)], not noise_free, model_size)
               for d in draws)
    hist = run_rounds(round_fn, point, state, fl, batched)
    return SimHistory(*(v if isinstance(v, tuple) else v[0] for v in hist))
