"""The production FL round: CA-AFL at model scale; port of
``repro.federated.rounds``.

One round:

  1. every client computes its local gradient on its block of the batch;
  2. per-example weights (selection mask × N/K) scale each client's
     contribution, so the gradient of the weighted mean loss IS the
     over-the-air superposition of eq. (10); the receiver noise σz/K is
     added to the aggregated gradient;
  3. the server optimizer applies it (plain SGD is the paper's
     model-averaging for one local step; AdamW is the beyond-paper
     option);
  4. per-client mean losses come back for the λ-ascent (the paper's
     control-channel scalars).

Gradients come from ``torch.func`` on the model's ``loss_fn``, so the tier
is generic over models with a ``per_example_nll`` and over the model zoo's
dense and ssm (xLSTM) families, whose parameters are flat dicts run
through the family's module (``models.api.Model``; their kernels carry
backward kernels). The reference jits each round and scans over
microbatches and over the probe's clients; here a round is eager PyTorch,
microbatches are a Python loop and the probe is a ``torch.func.vmap`` over
the client blocks, a chunk of them at a time (through the zoo's kernels
by their autograd.Functions' ``vmap`` rules).

Randomness is an input, as everywhere in the port: a round takes the
receiver noise z as a flat [P] vector in sorted-leaf order (the round's
``RoundDraws.noise``) instead of a key. The reference draws it per leaf,
and a leaf with ``ndim >= 2`` and more than 4 rows one row at a time
(``add_awgn``); a test fills z from that discipline to match it.

Selection, λ bookkeeping, channels and the energy ledger are host-side in
``server.py`` (O(N) scalars: the paper's control channel).

On a client mesh (``axis``, a ``sharding.ClientAxis`` of D ranks) each
rank is given its chunk of the batch, rows [r·B/D, (r+1)·B/D), and does
that chunk's gradient work: the dense round differentiates the chunk's
share of the weighted loss (the global 1/B kept), the gather round the
selected blocks the chunk holds, the probe its N/D blocks. The gradients
and the loss meet in one psum, the per-client sums of the loss probe in
another, and the rest (the receiver noise, the optimizer) is replicated.
The reference places its batch over the mesh and leaves the compiled
round to XLA's partitioner; here the split is written out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.federated.client import client_weights
from repro_torch.models.dense import per_token_nll
from repro_torch.optim import apply_updates
from repro_torch.utils.tree import (leaf_names, ravel, tree_l2_norm,
                                    unravel)


class FLRoundMetrics(NamedTuple):
    loss: torch.Tensor           # weighted global loss (selected set)
    client_losses: torch.Tensor  # [N] per-client mean loss (control channel)
    grad_norm: torch.Tensor


def _psum_grads(grads: dict, loss: torch.Tensor, axis):
    """(grads, loss) summed over ``axis`` in one collective."""
    flat = torch.cat([ravel(grads, torch.float32), loss.reshape(1).float()])
    flat = axis.psum(flat)
    return unravel(grads, flat[:-1], lead=0), flat[-1].to(loss.dtype)


def make_fl_round(model, optimizer, num_clients: int, clients_per_round: int,
                  noise_std: float = 0.0, ctx=None, microbatches: int = 1,
                  fused_probe: bool = False, gather_k: bool = False,
                  axis=None):
    """Returns round_fn(params, opt_state, batch, mask, z=None) -> (params,
    opt_state, FLRoundMetrics).

    batch must carry "client_ids" [B] mapping each example to its client;
    ``z`` [P] is the receiver noise, read only when ``noise_std`` is not 0.
    ``microbatches`` > 1 accumulates gradients over B/microbatches slices in
    the params' dtype, each term divided by ``microbatches`` first (each
    client's rows must be contiguous so every slice covers all clients).

    ``gather_k=True`` builds the selected-K gather round instead:
    ``round_fn(params, opt_state, batch, mask, idx, z=None)`` takes the
    top-K index vector [K] of ``selection.select_clients_sparse`` and runs
    the descent forward and backward on only the K selected clients'
    example blocks, with the full batch's ``/B`` normalizer, so the update
    equals the dense round's to summation order. It needs the canonical
    batch layout (block j = client j's B/N contiguous examples; the server
    checks it on the host and falls back to the dense round otherwise) and
    is exclusive with ``microbatches``/``fused_probe``. Gated slots ride
    along with weight 0.

    ``fused_probe`` (beyond the paper): the per-client losses of the
    λ-ascent come from the descent forward at w^t instead of a second
    forward at w^{t+1}, one round stale.

    ``axis`` (a client mesh): ``batch`` is this rank's chunk of the global
    batch (see the module docstring), the mask, ``idx`` and ``z`` the
    replicated ones; no microbatches or fused probe.
    """
    if not 1 <= clients_per_round <= num_clients:
        raise ValueError(
            f"clients_per_round={clients_per_round} must be in "
            f"[1, num_clients={num_clients}]")
    if axis is not None and (microbatches != 1 or fused_probe):
        raise ValueError("a round on a client mesh takes no microbatches or "
                         "fused probe")
    if gather_k:
        if microbatches != 1 or fused_probe:
            raise ValueError(
                "gather_k is exclusive with microbatches/fused_probe: the "
                "gathered sub-batch covers only the selected clients")
        return _make_gather_round(model, optimizer, num_clients, noise_std,
                                  ctx, axis)

    def weighted_loss_and_perex(p, b, mask):
        # K is the actual scheduled count: the static clients_per_round for
        # exact-K selection, and the eq. (10) normalizer when gating (or
        # GCA) schedules a varying number of clients
        k_sched = torch.clamp_min(torch.sum(mask), 1.0)
        w = client_weights(mask, b["client_ids"], k_sched)
        if fused_probe:
            per_ex = _per_example_nll(model, p, b, ctx)
            return torch.mean(per_ex * w), per_ex
        b = dict(b)
        b["weights"] = w
        return model.loss_fn(p, b, ctx), torch.zeros_like(w)

    def loss_and_grads(params, b, mask):
        """(grads, loss, per-example NLL) of one (micro)batch."""
        grads, (loss, per_ex) = grad_and_value(
            lambda p: weighted_loss_and_perex(p, b, mask), has_aux=True)(params)
        return grads, loss, per_ex

    def chunk_loss(p, b, mask):
        # this rank's share of the global weighted mean: Σ_chunk w·nll / B
        k_sched = torch.clamp_min(torch.sum(mask), 1.0)
        w = client_weights(mask, b["client_ids"], k_sched)
        return (torch.sum(_per_example_nll(model, p, b, ctx) * w)
                / (b["client_ids"].shape[0] * axis.size))

    def round_fn(params, opt_state, batch, mask, z=None):
        cids = batch["client_ids"]
        if axis is not None:
            grads, loss = grad_and_value(
                lambda p: chunk_loss(p, batch, mask))(params)
            grads, loss = _psum_grads(grads, loss, axis)
        elif microbatches == 1:
            grads, loss, per_ex = loss_and_grads(params, batch, mask)
        else:
            bsz = cids.shape[0]
            if bsz % microbatches:
                raise ValueError(f"batch of {bsz} does not split into "
                                 f"{microbatches} microbatches")
            mb = {k: v.reshape((microbatches, bsz // microbatches) + v.shape[1:])
                  for k, v in batch.items()}
            # accumulate in the params' dtype (an f32 accumulator would cost
            # 2x the params' bytes at scale); each term pre-divided
            loss = torch.zeros((), dtype=torch.float32, device=cids.device)
            grads = {name: torch.zeros_like(params[name])
                     for name in leaf_names(params)}
            per_mb = []
            for i in range(microbatches):
                g, l, pe = loss_and_grads(params, {k: v[i] for k, v in mb.items()},
                                          mask)
                loss = loss + l / microbatches
                grads = {name: grads[name] + g[name] / microbatches
                         for name in leaf_names(grads)}
                per_mb.append(pe)
            per_ex = torch.cat(per_mb)

        # AirComp receiver noise z/K on the aggregated update, K the actual
        # scheduled count (the same normalizer as the gradient weights)
        if noise_std:
            grads = add_awgn(grads, z, noise_std
                             / torch.clamp_min(torch.sum(mask), 1.0))

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)

        if fused_probe:
            # beyond the paper: stale (w^t) losses from the descent forward
            client_losses = _segment_mean(per_ex, cids, num_clients)
        else:
            # Alg. 1 line 12: a second forward on the NEW model
            client_losses = per_client_losses(model, params, batch,
                                              num_clients, ctx,
                                              microbatches=microbatches,
                                              axis=axis)
        return params, opt_state, FLRoundMetrics(
            loss=loss, client_losses=client_losses,
            grad_norm=tree_l2_norm(grads))

    return round_fn


def _make_gather_round(model, optimizer, num_clients: int, noise_std, ctx,
                       axis=None):
    """The selected-K production round (``make_fl_round(gather_k=True)``).

    The dense round's weighted mean over all B examples is
    ``(1/B)·Σ_b mask[cid_b]·(N/K)·nll_b``: every unselected example adds an
    exact 0 yet pays its forward and backward. Here the K selected blocks
    are gathered first and the same sum runs over K·(B/N) examples with the
    same ``/B``. The λ-ascent probe stays full-population. On a mesh each
    rank gathers the selected blocks of its chunk (clients [r·N/D,
    (r+1)·N/D) in the canonical layout), possibly none, and the partial
    gradients meet in a psum that every rank joins.
    """
    ranks = 1 if axis is None else axis.size
    blocks = num_clients // ranks   # client blocks in a rank's chunk

    def round_fn(params, opt_state, batch, mask, idx, z=None):
        bsz = batch["client_ids"].shape[0] * ranks   # the global batch
        m = bsz // num_clients  # examples per client block
        k_sched = torch.clamp_min(torch.sum(mask), 1.0)
        idx = idx.long()
        lidx = idx
        if axis is not None:
            off = axis.rank * blocks
            idx = idx[(idx >= off) & (idx < off + blocks)]
            lidx = idx - off
        rows = (lidx[:, None] * m
                + torch.arange(m, device=idx.device)[None, :]).reshape(-1)
        sub = {name: v[rows] for name, v in batch.items()}
        # the gathered rows' weights: the dense round's mask[cid]·N/K, with
        # gated slots (mask[idx] == 0) adding 0
        w = torch.repeat_interleave(mask[idx], m) * (num_clients / k_sched)

        def loss_fn(p):
            per_ex = _per_example_nll(model, p, sub, ctx)
            return torch.sum(per_ex * w) / bsz

        if idx.numel():
            grads, loss = grad_and_value(loss_fn)(params)
        else:
            # a rank whose chunk holds no selected block joins the psum with
            # exact zeros, the gradient and loss of an empty sum, and runs
            # no forward (the kernels take no 0-row launch)
            grads = {name: torch.zeros_like(params[name]) for name in leaf_names(params)}
            loss = torch.zeros((), dtype=torch.float32, device=idx.device)
        if axis is not None:
            grads, loss = _psum_grads(grads, loss, axis)
        if noise_std:
            grads = add_awgn(grads, z, noise_std / k_sched)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        client_losses = per_client_losses(model, params, batch, num_clients,
                                          ctx, axis=axis)
        return params, opt_state, FLRoundMetrics(
            loss=loss, client_losses=client_losses,
            grad_norm=tree_l2_norm(grads))

    return round_fn


def add_awgn(grads: dict, z: torch.Tensor, std) -> dict:
    """grads + std·z (eq. 10's receiver noise), ``z`` the flat [P] standard
    normals in sorted-leaf order, split back into the leaves; ``std`` a
    number or a 0-d tensor."""
    noise = unravel(grads, z, lead=0)
    return {name: grads[name] + std * noise[name] for name in leaf_names(grads)}


def _per_example_nll(model, params, batch, ctx):
    """[B] per-example NLL: a model's own ``per_example_nll`` (e.g.
    ``models.logreg.logistic_regression_prod``), else a zoo model's
    teacher-forced forward and the mean next-token NLL over positions."""
    if hasattr(model, "per_example_nll"):
        return model.per_example_nll(params, batch)
    logits = model.forward(params, batch["tokens"])
    return torch.mean(per_token_nll(logits[:, :-1], batch["labels"][:, 1:]), dim=-1)


def _segment_mean(per_ex: torch.Tensor, cids: torch.Tensor,
                  num_clients: int, axis=None) -> torch.Tensor:
    """[N] mean of ``per_ex`` over each client's examples (0 for a client
    with none): each client's row of an [N, B] membership mask picks its
    examples, and the rows are summed in one fixed order, so a run repeats
    bit for bit on the card (``index_add_``'s atomics do not). On a mesh
    the sums and counts of every rank's chunk meet in one psum."""
    member = (cids.long()[None, :]
              == torch.arange(num_clients, device=cids.device)[:, None])
    sums = torch.stack([torch.where(member, per_ex[None, :], 0).sum(dim=1),
                        member.sum(dim=1).to(per_ex.dtype)])
    if axis is not None:
        sums = axis.psum(sums)
    return sums[0] / torch.clamp_min(sums[1], 1.0)


def per_client_losses(model, params, batch, num_clients: int, ctx=None,
                      microbatches: int = 1, axis=None) -> torch.Tensor:
    """[N] mean loss per client: forward only, per-example NLL, segment
    mean. Alg. 1's ascent-side f_i(w̄^{t+1}; ξ̃) for all clients at once
    (the server masks it down to the ascent set), microbatched with the
    descent pass's slicing; on a mesh (``axis``) over this rank's chunk
    ``batch``, the segments summed over the ranks."""
    cids = batch["client_ids"]
    if microbatches == 1:
        per_ex = _per_example_nll(model, params, batch, ctx)
    else:
        bsz = cids.shape[0]
        mb = {k: v.reshape((microbatches, bsz // microbatches) + v.shape[1:])
              for k, v in batch.items()}
        per_ex = torch.cat([
            _per_example_nll(model, params, {k: v[i] for k, v in mb.items()}, ctx)
            for i in range(microbatches)])
    return _segment_mean(per_ex, cids, num_clients, axis)


# the most bytes of per-client gradients one chunk of the probe holds at
# once (f32 rows of P): 10 GiB makes chunks of 4 clients at qwen2-0.5b's
# P = 630,396,800 and at xlstm-1.3b's 8-layer cut (543,334,456), and of 1
# at its full 2,221,906,256; beside the quantized and sparse transports'
# two [8, P] buffers (40.3 GB at qwen2-0.5b) a chunk of 6 would not fit
# an 80 GB card with its transients
PROBE_CHUNK_BYTES = 10 * 2 ** 30


def probe_chunk(num_params: int, blocks: int) -> int:
    """The client blocks one vmapped chunk of the probe takes: as many as
    keep their f32 gradients within ``PROBE_CHUNK_BYTES``, at least one,
    at most ``blocks``."""
    return max(1, min(blocks, PROBE_CHUNK_BYTES // (4 * num_params)))


def make_grad_norm_probe(model, num_clients: int, ctx=None,
                         with_grads: bool = False, axis=None):
    """GCA's control-channel probe: [N] per-client gradient norms at w^t.

    GCA needs ‖∇f_i(w^t)‖ before the round's mask exists, so each client's
    mean-loss gradient is taken on its own block: a ``torch.func.vmap`` of
    ``grad_and_value`` over the [N, B/N, ...] blocks, run over
    ``probe_chunk`` blocks at a time (the reference scans the clients one
    at a time, and N clients' gradients at once would not fit beside a
    model of the zoo), each chunk's results written straight into the
    outputs. The batch must hold each client's examples contiguous and
    equally sized (B % N == 0). A norm is the square root of the sum over
    the leaves (sorted) of each leaf's f32 sum of squares, with or without
    the rows.

    ``with_grads=True`` returns ``(norms [N], losses [N], grads [N, P])``,
    each client's mean gradient raveled to a flat f32 row (sorted-leaf
    order) and its mean loss at w^t: the server reuses them as the round's
    update. Every output is written at each block's observed client id, so
    permuted blocks still land on the right client; no result depends on
    the chunk.

    On a mesh (``axis``) ``batch`` is this rank's chunk, N/D blocks: their
    norms and losses are placed into [N] by client id and summed over the
    ranks (each entry is its owner's, exactly), and the gradients are this
    rank's rows [N/D, P], in the chunk's block order.
    """
    blocks = num_clients if axis is None else num_clients // axis.size

    def client_loss(params, cbatch):
        return torch.mean(_per_example_nll(model, params, cbatch, ctx))

    per_client = vmap(grad_and_value(client_loss), in_dims=(None, 0))

    def probe(params, batch):
        bsz = batch["client_ids"].shape[0]
        if bsz % blocks:
            raise ValueError("the probe needs equal per-client batches")
        mb = {k: v.reshape((blocks, bsz // blocks) + v.shape[1:])
              for k, v in batch.items()}
        obs = mb["client_ids"][:, 0].long()
        names = leaf_names(params)
        sizes = [params[name].numel() for name in names]
        step = probe_chunk(sum(sizes), blocks)
        f32 = dict(dtype=torch.float32, device=obs.device)
        sums = torch.zeros((2, num_clients), **f32)   # squared norms, losses
        rows = (torch.zeros((num_clients if axis is None else blocks, sum(sizes)), **f32)
                if with_grads else None)
        for lo in range(0, blocks, step):
            hi = min(lo + step, blocks)
            grads, losses = per_client(params, {k: v[lo:hi] for k, v in mb.items()})
            at = obs[lo:hi]
            sq = sum(torch.sum(torch.square(grads[name].to(torch.float32)).flatten(1),
                               dim=-1) for name in names)
            sums.index_copy_(1, at, torch.stack([sq, losses.to(torch.float32)]))
            if with_grads:
                off = 0
                for name, size in zip(names, sizes):
                    g = grads[name].reshape(hi - lo, size).to(torch.float32)
                    if axis is None:
                        rows[:, off:off + size].index_copy_(0, at, g)
                    else:
                        rows[lo:hi, off:off + size] = g
                    off += size
            del grads
        if axis is not None:
            sums = axis.psum(sums)
        norms = torch.sqrt(sums[0])
        if not with_grads:
            return norms
        return norms, sums[1], rows

    return probe
