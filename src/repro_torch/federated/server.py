"""Host-side parameter server: selection, λ bookkeeping, energy ledger;
port of ``repro.federated.server``.

The server drives the production round (``rounds.py``). What it handles on
the host is O(N) scalars per round (channel states, selection, λ, energy:
the paper's control channel); the local gradients and the over-the-air
aggregation run on the device.

Where the aggregation meets a kernel: the GCA probe-reuse apply sums the
[N, P] probe gradients with ``aircomp`` (analog and digital), and the
quantized and sparse transports, under any method, send every client's
delta -η·g_i through ``quant_aircomp`` / ``sparse_aircomp`` over all N
rows, once a round each. The exact-K analog and digital rounds aggregate
by the gradient of a weighted loss and reach no kernel, as in the
reference.

Randomness: one ``RoundDraws`` a step (``core/draws.py``), given to
:meth:`ParameterServer.step` or drawn from the server's own three
generator streams seeded from ``seed`` (the streams of
``draws.round_draws``; the batch-index fields go unused, since batches
come from the data pipeline); a temporal run's ``InitDraws`` likewise.
The reference derives the same roles from one 7-way split of its key a
step, the simulator's role order, so a test that fills the draws from the
reference's key chain reproduces its steps. Every path reads the receiver
noise as the [P] ``RoundDraws.noise`` in sorted-leaf order.

Under the sharded control plane (``control_plane="sharded"``) the server
is one device with ``ids = arange(N)``: its channels, ``ChanState``,
selection and ascent-set Gumbel noise and rounding uniforms are the
clients' id-addressed draws (``draws.HashDraws`` from ``seed``, round t
of the source at step t, read as one ``RoundDraws`` by
``draws.client_rows``), and λ is projected by the simulator's bisection,
so one step equals one round of the sharded simulator.

On a client mesh (``mesh``, a ``sharding.ClientAxis`` of D ranks, each a
process that calls :meth:`ParameterServer.step` with the same global
batch and draws) every rank does its chunk of the gradient work, rows
[r·B/D, (r+1)·B/D) of the batch (N/D client blocks in whatever client
order the batch holds them), and the rest is replicated, bit for bit
across the ranks: channels, selection, the GCA threshold, λ and its
projection, the energy ledger, the temporal state and the history. The
rounds (``rounds.py``) psum their gradients; the GCA apply sums each
rank's probe rows with ``aircomp_psum_tree``, the quantized and sparse
applies with ``transport.quantized_psum_rows`` / ``sparse_psum_rows`` (no
AirComp kernel on a mesh: the reference's psum trees are plain sums), and
the sparse error-feedback residual [N, P] stays whole on every rank, each
rank writing its clients' rows (``sharding.merge_owned_rows``), so a batch
that moves clients between ranks from step to step still gives the
one-device result. The reference's mesh is placement only (it
``shard_batch``es the batch and leaves the round to XLA); a mesh of one
is the plain server.

Models: the logistic regression (``per_example_nll``) and the model zoo's
dense and ssm (xLSTM) families (``models.api.Model``, parameters a flat
dict made by ``init_state`` from a ``torch.Generator`` on the device
seeded with ``seed``; batches of ``tokens``, ``labels`` and
``client_ids``), on every path: the exact-K methods and GCA, the four
transports, one device or a client mesh. On a zoo model the per-client
probe is a ``torch.func.vmap`` through the kernels' autograd.Functions
(their ``vmap`` rules), a chunk of clients at a time, and its [N, P] rows
are the largest buffer of a step: the applies write the payloads and the
sparse residual into them in place rather than copy them. The moe,
hybrid, vlm and audio families raise at their first forward
(``models/api.py``, ROADMAP Queue 1 item 10(e)).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import transport as transport_mod
from repro_torch.core.aircomp import aircomp_psum_tree
from repro_torch.core.channel import (draw_channels_scenario, effective_channel,
                                      scenario_from_config)
from repro_torch.core.draws import (HashDraws, InitDraws, RoundDraws,
                                    client_init_rows, client_rows, draw_init,
                                    draw_round, seed_generators)
from repro_torch.core.dro import lambda_ascent, lambda_summary
from repro_torch.core.dynamics import (commit_process, init_chan_state,
                                       process_from_config, step_process)
from repro_torch.core.selection import (EXACT_K_METHODS, availability_logits,
                                        gumbel_topk, select_clients,
                                        select_clients_sparse)
from repro_torch.core.sharding import check_divisible, merge_owned_rows
from repro_torch.core.simulator import mesh_size
from repro_torch.federated.rounds import (FLRoundMetrics, add_awgn,
                                          make_fl_round, make_grad_norm_probe,
                                          per_client_losses)
from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat
from repro_torch.optim import apply_updates
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import ravel, tree_l2_norm, tree_size, unravel


@dataclass
class ServerState:
    params: dict
    opt_state: Any
    lam: torch.Tensor
    round: int = 0
    energy_joules: float = 0.0
    history: List[Dict] = field(default_factory=list)
    chan_state: Any = ()  # dynamics.ChanState for temporal runs, () otherwise
    # λ on the FLConfig.record_lambda_every cadence (rounds t % E == 0; none
    # at E = 0), device tensors
    lam_snaps: List = field(default_factory=list)
    # sparse transport only: per-client error-feedback memory [N, P]
    ef_resid: Any = ()
    # the downlink share of energy_joules (which is the total ledger)
    dl_energy_joules: float = 0.0


class ParameterServer:
    """CA-AFL parameter server for the production tier. ``device=None`` is
    the CUDA card, and raises when there is none. ``mesh``: a client axis
    (``sharding.ClientAxis``) whose ranks each run this server on the same
    batches; None or a mesh of one is one device."""

    def __init__(self, model, optimizer, fl: FLConfig, *, ctx=None,
                 seed: int = 0, reuse_probe_grads: bool = True, mesh=None,
                 device=None):
        if fl.control_plane not in ("replicated", "sharded"):
            raise ValueError(f"unknown control_plane {fl.control_plane!r}; "
                             "pick 'replicated' or 'sharded'")
        self.axis = mesh if mesh_size(mesh) > 1 else None
        if self.axis is not None:
            check_divisible(fl.num_clients, self.axis.size)
        self._zoo = not hasattr(model, "per_example_nll")
        transport_mod.require_ported(fl.transport)
        if fl.method not in EXACT_K_METHODS + ("gca",):
            raise ValueError(f"unknown selection method {fl.method!r}")
        self.device = resolve_device(device)
        self.model, self.fl, self.optimizer = model, fl, optimizer
        self._seed = seed
        n, k = fl.num_clients, fl.clients_per_round
        # the digital scheme decodes each payload orthogonally: no
        # superposition, so no receiver noise on the aggregate
        self.transport = transport_mod.transport_from_config(fl, self.device)
        self._round_noise = 0.0 if fl.transport == "digital" else fl.noise_std
        quantized = fl.transport == "quantized"
        sparse = fl.transport == "sparse"
        # quantized/sparse always apply the fused compressed-delta aggregate
        # (no dense round, and no dense fallback: the delta probe needs the
        # one-block-per-client layout)
        axis = self.axis
        self.round_fn = self._gather_round = None
        if not (quantized or sparse):
            self.round_fn = make_fl_round(model, optimizer, n, k,
                                          noise_std=self._round_noise, ctx=ctx,
                                          axis=axis)
            if fl.method in EXACT_K_METHODS:
                # the selected-K gather round, whenever the batch has the
                # canonical block layout (checked on the host each step)
                self._gather_round = make_fl_round(
                    model, optimizer, n, k, noise_std=self._round_noise,
                    ctx=ctx, gather_k=True, axis=axis)
        self.scenario = scenario_from_config(fl, self.device)
        self.process = process_from_config(fl, self.device)
        self._model_size = None   # from the params at init_state / step
        # GCA needs the per-client gradient norms before selection: a probe
        # at the current params. With reuse_probe_grads it also returns each
        # client's mean loss and flat gradient, whose masked aggregate is
        # the round's descent update (no second forward and backward), at
        # the price of an [N, P] f32 stack.
        self._reuse_probe_grads = reuse_probe_grads
        self._grad_probe = None
        if fl.method == "gca":
            self._grad_probe = make_grad_norm_probe(
                model, n, ctx=ctx,
                with_grads=reuse_probe_grads or quantized or sparse, axis=axis)
        # quantized/sparse: every client's payload is its SGD delta -η·g_i,
        # so the server needs per-client gradients under any method
        self._delta_probe = None
        if quantized or sparse:
            warnings.warn(
                f"transport={fl.transport!r} applies the paper's SGD "
                "aggregation directly: per-client deltas are -eta*grad with "
                "eta = fl.lr0 * fl.lr_decay**round (matching the simulator "
                "tier); the passed optimizer's update rule is NOT used and "
                "its state passes through untouched", stacklevel=2)
            self._delta_probe = self._grad_probe or make_grad_norm_probe(
                model, n, ctx=ctx, with_grads=True, axis=axis)
        # the control channel's loss probe for rounds where nobody
        # transmits: the λ-ascent still needs f_i(w̄)
        self._loss_probe = lambda p, b: per_client_losses(model, p, b, n, ctx,
                                                          axis=axis)
        self._gen, self._quant_gen, self._temporal_gen = seed_generators(
            seed, self.device)
        # the temporal stream opens with the initial state's draws, as a
        # seeded simulator run's does
        self._init_draws = draw_init(self._temporal_gen, fl)
        # the sharded control plane: every client's draws by its id
        self._ids = self._id_draws = None
        if fl.control_plane == "sharded":
            self._ids = torch.arange(n, dtype=torch.int64, device=self.device)
            self._id_draws = HashDraws(seed, self.device)
            self._init_draws = client_init_rows(self._id_draws, fl, self._ids)

    # ------------------------------------------------------------------
    # the three aggregate applies
    # ------------------------------------------------------------------

    def _gca_apply(self, params, opt_state, gflat, probe_losses, mask, z,
                   lids=None):
        """The probe-reuse descent: the masked flat aggregate of the probe's
        per-client gradients (``aircomp`` with σ = 0; on a mesh this rank's
        rows, clients ``lids``, through ``aircomp_psum_tree``), the receiver
        noise σ/K added per leaf after the unravel as the dense round adds
        it, then the server optimizer."""
        k_sched = torch.clamp_min(torch.sum(mask), 1.0)
        if self.axis is None:
            agg = aircomp_aggregate_flat(gflat, mask, torch.zeros_like(gflat[0]),
                                         noise_std=0.0, k=k_sched)
        else:
            agg = aircomp_psum_tree({"g": gflat}, mask[lids], self.axis,
                                    k=k_sched)["g"]
        grads = unravel(params, agg, lead=0)
        if self._round_noise:
            grads = add_awgn(grads, z, self._round_noise / k_sched)
        gnorm = tree_l2_norm(grads)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        # the dense round's weighted loss == (1/K)·Σ_{i∈D} mean-loss_i,
        # which the probe measured at w^t
        loss = torch.sum(mask * probe_losses) / k_sched
        return params, opt_state, loss, gnorm

    def _delta_apply(self, params, gflat, probe_losses, mask, d, eta, resid,
                     lids=None):
        """The quantized or sparse round: each client's payload is its SGD
        delta -η·g_i from the probe (same batch, same params), rounded with
        its row of the round's uniforms or top-k compressed with its
        carried residual, and the fused masked aggregate of eq. (10) is
        added to the params directly: one simulator round at
        local_steps = 1. The optimizer is bypassed. On one device the
        payloads are made in ``gflat``'s own storage (it is consumed), and
        under the sparse transport the new residual is written there too,
        a row at a time, so no further [N, P] buffer is made. On a mesh
        ``gflat`` is this rank's rows, clients ``lids``: their uniforms and
        residuals are read by client id and the partial sums meet in a
        psum. Returns ``(params, loss, gnorm, resid)``."""
        k_sched = torch.clamp_min(torch.sum(mask), 1.0)
        flat = ravel(params, torch.float32)
        deltas = gflat.mul_(-eta) if self.axis is None else (-eta) * gflat
        noise_std = self._round_noise
        z = d.noise if noise_std else None
        axis = self.axis
        if self.fl.transport == "quantized":
            if d.quant_uniform is None:
                raise ValueError("the quantized transport needs the round's "
                                 "RoundDraws.quant_uniform")
            if axis is None:
                new_flat = transport_mod.quantized_aggregate_flat_rows(
                    flat, deltas, mask, d.quant_uniform, noise_std,
                    self.transport.bits, k_sched, z=z)
            else:
                new_flat = flat + transport_mod.quantized_psum_rows(
                    deltas, mask[lids], d.quant_uniform[lids], z, noise_std,
                    self.transport.bits, k_sched, axis)
        else:
            k_coords = transport_mod.sparse_k_coords(self.fl.sparse_density,
                                                     flat.shape[0])
            if axis is None:
                new_flat, resid = transport_mod.sparse_aggregate_rows_in_place(
                    flat, deltas.add_(resid), resid, mask, noise_std, k_coords,
                    k_sched, z=z)
            else:
                agg, rows = transport_mod.sparse_psum_rows(
                    deltas, resid[lids], mask[lids], z, noise_std, k_coords,
                    k_sched, axis)
                new_flat = flat + agg
                resid = merge_owned_rows(resid.index_copy(0, lids, rows),
                                         lids, axis)
        gnorm = torch.sqrt(torch.sum(torch.square(new_flat - flat))) / eta
        loss = torch.sum(mask * probe_losses) / k_sched
        return unravel(params, new_flat, lead=0), loss, gnorm, resid

    # ------------------------------------------------------------------
    # host-side layout checks
    # ------------------------------------------------------------------

    def _gather_layout_ok(self, cids: np.ndarray) -> bool:
        """The gather round indexes block j as client j's examples: the
        canonical ascending-contiguous layout of the data pipeline. Any
        other layout falls back to the dense round."""
        n = self.fl.num_clients
        if cids.shape[0] % n:
            return False
        return bool((cids == np.repeat(np.arange(n), cids.shape[0] // n)).all())

    def _check_probe_layout(self, cids: np.ndarray) -> None:
        """The probe slices the batch into one equal-size block per client:
        every block must be a single client and every client appear once,
        or norms would be attributed to the wrong clients."""
        n = self.fl.num_clients
        if cids.shape[0] % n:
            raise ValueError("GCA probe needs batch size divisible by N")
        blocks = cids.reshape(n, -1)
        if not (blocks == blocks[:, :1]).all() or \
                len(set(blocks[:, 0].tolist())) != n:
            raise ValueError(
                "GCA probe needs one contiguous equal-size block of examples "
                "per client (any client order), got mixed/missing clients")

    # ------------------------------------------------------------------

    def init_state(self, init_draws: Optional[InitDraws] = None) -> ServerState:
        """The model's init (a zoo model's from a generator on the device
        seeded with ``seed``), uniform λ, zero ledgers; a temporal run's
        process state from ``init_draws`` (default: the server's own, the
        first numbers of its temporal stream), and zero error-feedback
        residuals under the sparse transport."""
        fl = self.fl
        if self._zoo:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._seed)
            params = self.model.init_params(gen)
        else:
            params = self.model.init(self.device)
        self._model_size = tree_size(params)
        chan_state = ()
        if fl.temporal:
            init = self._init_draws if init_draws is None else init_draws
            chan_state = init_chan_state(self.process,
                                         init.fast_normal.to(self.device))
        f32 = dict(dtype=torch.float32, device=self.device)
        ef_resid = (torch.zeros((fl.num_clients, self._model_size), **f32)
                    if fl.transport == "sparse" else ())
        return ServerState(
            params=params,
            opt_state=self.optimizer.init(params, self.device),
            lam=torch.full((fl.num_clients,), 1.0 / fl.num_clients, **f32),
            chan_state=chan_state,
            ef_resid=ef_resid,
        )

    def _batch(self, batch: Dict):
        """(the batch on the server's device, its client ids on the host):
        on a mesh this rank's chunk of the batch and the global ids."""
        cids = batch["client_ids"]
        cids = (cids.cpu().numpy() if isinstance(cids, torch.Tensor)
                else np.asarray(cids))
        if self.axis is not None:
            chunk, rem = divmod(cids.shape[0], self.axis.size)
            if rem:
                raise ValueError(f"a batch of {cids.shape[0]} examples does "
                                 f"not split over {self.axis.size} ranks")
            lo = self.axis.rank * chunk
            batch = {name: v[lo:lo + chunk] for name, v in batch.items()}
        return ({name: torch.as_tensor(v).to(self.device)
                 for name, v in batch.items()}, cids)

    def _local_ids(self, cids: np.ndarray) -> torch.Tensor:
        """The client ids of this rank's blocks, in the batch's order (a
        layout the probe checks accepted)."""
        n = self.fl.num_clients
        lo = self.axis.rank * (n // self.axis.size)
        ids = cids.reshape(n, -1)[lo:lo + n // self.axis.size, 0]
        return torch.as_tensor(ids.astype(np.int64), device=self.device)

    def step(self, state: ServerState, batch: Dict,
             draws: Optional[RoundDraws] = None) -> ServerState:
        """One CA-AFL round on ``batch`` (``x``/``labels``/``client_ids``,
        numpy or tensors) with the round's ``draws`` (default: drawn from
        the server's generators, or under the sharded control plane the
        clients' id-addressed draws of this round)."""
        fl = self.fl
        n, k = fl.num_clients, fl.clients_per_round
        if self._model_size is None:
            self._model_size = tree_size(state.params)
        model_size = self._model_size
        if draws is None and self._id_draws is not None:
            draws = client_rows(self._id_draws.round(state.round), fl,
                                self._ids, model_size, 1)
        elif draws is None:
            draws = draw_round(self._gen, self._quant_gen, fl, model_size, 1,
                               temporal_gen=self._temporal_gen)
        d = draws.to(self.device)
        batch, cids = self._batch(batch)
        gca = fl.method == "gca"

        # --- physical layer: the simulator's tick -----------------------
        if fl.temporal:
            cs = state.chan_state
            pstep = step_process(d, self.scenario, self.process, cs,
                                 fl.num_subcarriers, model_size,
                                 scheme=fl.transport, tp=self.transport,
                                 dl_num_tx=k)
            h, avail, eligible = pstep.h, pstep.avail, pstep.eligible
        else:
            h = effective_channel(draw_channels_scenario(
                d.chan_normal, d.shadow_normal, self.scenario,
                fl.num_subcarriers))
            avail = eligible = None

        # --- selection ----------------------------------------------------
        idx = probe_losses = gflat = lids = None
        if gca:
            self._check_probe_layout(cids)
            if self._reuse_probe_grads or self._delta_probe is not None:
                gnorms, probe_losses, gflat = self._grad_probe(state.params,
                                                               batch)
            else:
                gnorms = self._grad_probe(state.params, batch)
            mask = select_clients("gca", None, state.lam, h, k,
                                  grad_norms=gnorms, gca=fl.gca, avail=eligible)
        else:
            # the simulator's top-k: the mask for the ledger and λ, the
            # indices for the gather round
            mask, idx = select_clients_sparse(
                fl.method, d.sel_gumbel, state.lam, h, k, C=fl.energy_C,
                avail=eligible)
            if self._delta_probe is not None:
                try:
                    self._check_probe_layout(cids)
                except ValueError as e:
                    raise ValueError(
                        f"transport={fl.transport!r} needs the canonical "
                        "one-contiguous-block-per-client batch layout for "
                        f"its per-client delta probe (no dense fallback): {e}"
                    ) from e
                _, probe_losses, gflat = self._delta_probe(state.params, batch)
        if gflat is not None and self.axis is not None:
            lids = self._local_ids(cids)

        # --- the round ------------------------------------------------------
        ef_resid = state.ef_resid
        if fl.transport == "sparse" and isinstance(ef_resid, tuple):
            # a hand-built ServerState that skipped init_state: the memory
            # starts empty, as init_state's zeros
            ef_resid = torch.zeros((n, model_size), dtype=torch.float32,
                                   device=self.device)
        # a static exact-K round always schedules K; a temporal or GCA one
        # may schedule nobody (a host read, as in the reference)
        empty = (fl.temporal or gca) and int(torch.sum(mask)) == 0
        z = d.noise
        if self._round_noise and z is None:
            raise ValueError("a noisy round needs the round's RoundDraws.noise")
        if empty:
            # nothing transmits: the server receives no superposition, so
            # the model, the optimizer state and the residuals stay put;
            # only the loss probe runs, for the λ-ascent
            params, opt_state = state.params, state.opt_state
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            metrics = FLRoundMetrics(
                loss=zero, client_losses=self._loss_probe(state.params, batch),
                grad_norm=zero)
        elif self._delta_probe is not None:
            # η follows the simulator's decayed schedule at this round
            eta = torch.full((), fl.lr0 * fl.lr_decay ** state.round,
                             dtype=torch.float32, device=self.device)
            params, loss, gnorm, ef_resid = self._delta_apply(
                state.params, gflat, probe_losses, mask, d, eta, ef_resid, lids)
            opt_state = state.opt_state
            metrics = FLRoundMetrics(
                loss=loss, client_losses=self._loss_probe(params, batch),
                grad_norm=gnorm)
        elif gflat is not None:
            params, opt_state, loss, gnorm = self._gca_apply(
                state.params, state.opt_state, gflat, probe_losses, mask, z,
                lids)
            metrics = FLRoundMetrics(
                loss=loss, client_losses=self._loss_probe(params, batch),
                grad_norm=gnorm)
        elif idx is not None and self._gather_round is not None \
                and self._gather_layout_ok(cids):
            params, opt_state, metrics = self._gather_round(
                state.params, state.opt_state, batch, mask, idx, z)
        else:
            params, opt_state, metrics = self.round_fn(
                state.params, state.opt_state, batch, mask, z)

        # --- energy ledger: the selected set's uplink under the transport,
        # and every listening client's broadcast receive (exactly 0 at the
        # default dl_rx_power = 0) ----------------------------------------
        e_round = transport_mod.round_energy(fl.transport, self.transport, h,
                                             mask, model_size, self.scenario)
        recv_count = torch.sum(pstep.recv) if fl.temporal else float(n)
        e_dl = recv_count * transport_mod.downlink_energy(
            fl.transport, self.transport, model_size, self.scenario, num_tx=k)

        # --- temporal carry: batteries and process state --------------------
        chan_state = (commit_process(pstep, cs, mask) if fl.temporal
                      else state.chan_state)

        # --- λ-ascent on a uniform K-subset of the available clients --------
        amask, _ = gumbel_topk(d.asc_gumbel,
                               torch.zeros_like(state.lam)
                               + availability_logits(avail), k)
        if avail is not None:
            amask = amask * avail
        # the sharded plane projects by the simulator's bisection
        lam = lambda_ascent(state.lam, metrics.client_losses, amask,
                            fl.ascent_lr, local_rows=self._ids is not None)
        lam_max, lam_entropy, lam_ess = lambda_summary(lam)

        # --- the history row: one host copy ---------------------------------
        vals = [metrics.loss, e_round, e_dl, torch.sum(mask),
                torch.max(metrics.client_losses), metrics.grad_norm, lam_max,
                lam_entropy, lam_ess]
        if fl.temporal:
            vals += [torch.sum(eligible), torch.min(chan_state.battery)]
        host = torch.stack([torch.as_tensor(v).reshape(()).to(torch.float32)
                            for v in vals]).cpu().tolist()
        loss, e_up, e_dl_h, sched, worst, gnorm, lmax, lent, less = host[:9]
        row = {
            "round": state.round,
            "loss": loss,
            "energy_j": e_up + e_dl_h,
            "dl_energy_j": e_dl_h,
            "num_scheduled": int(sched),
            "worst_client_loss": worst,
            "grad_norm": gnorm,
            "lam_max": lmax,
            "lam_entropy": lent,
            "lam_ess": less,
        }
        if fl.temporal:
            row["avail_count"] = int(host[9])
            row["min_battery"] = host[10]
        state.history.append(row)
        e_rec = fl.record_lambda_every
        if e_rec >= 1 and state.round % e_rec == 0:
            state.lam_snaps.append(lam)
        return ServerState(
            params=params, opt_state=opt_state, lam=lam,
            round=state.round + 1,
            energy_joules=state.energy_joules + e_up + e_dl_h,
            history=state.history,
            chan_state=chan_state,
            lam_snaps=state.lam_snaps,
            ef_resid=ef_resid,
            dl_energy_joules=state.dl_energy_joules + e_dl_h,
        )

    def run(self, state: ServerState, batches, rounds: int,
            log_every: int = 10, log_fn: Optional[Callable] = print):
        for t in range(rounds):
            state = self.step(state, next(batches))
            if log_fn and (t % log_every == 0 or t == rounds - 1):
                h = state.history[-1]
                log_fn(
                    f"round {h['round']:4d} loss={h['loss']:.4f} "
                    f"worst={h['worst_client_loss']:.4f} "
                    f"E={state.energy_joules:.3e} J "
                    f"sched={h['num_scheduled']}")
        return state
