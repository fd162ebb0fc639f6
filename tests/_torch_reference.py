"""Shared helpers of the port's parity tests: the reference's random numbers
as the port's ``RoundDraws``, and the history comparison with the
simulator's tolerances.

``reference_draws`` replays the reference's key discipline with
``jax.random`` (the 7-way per-round split of ``repro/core/simulator.py``,
from ``split(PRNGKey(seed))[1]`` as ``init_sim_state`` takes it), so both
packages see the same channels, Gumbel noise, batches, AWGN and
quantization uniforms (the reference's own ``_client_uniforms`` of the
round's noise key, for all N clients), and for a temporal run the shadow
walk's normals and the availability uniforms (``fold_in(k_chan, 2)`` and
``fold_in(k_chan, 3)``); ``reference_init_draws`` gives the initial fading
normals, ``normal(fold_in(k_init, 1), (2, N, draw_sc))``. The reference's
sweep seeds cell (p, s) with ``PRNGKey(s)`` as ``run_simulation(seed=s)``
does, so ``reference_draws(fl_p, s, ...)`` is that cell's stream too.

``ReferenceIdDraws`` is the sharded control plane's counterpart, a
``repro_torch.core.draws.IdDraws`` that answers with the reference's own
per-id numbers: each stream is a JAX key of the same discipline (the 7-way
split, ``fold_in`` per stream, ``client_keys(k, ids)`` per client, the
quantizer's ``fold_in(fold_in(k_noise, 7), id)``, the ascent and the
descent-loss batches both from ``k_abatch``), which fills a full-N table
from ``jax.random`` once and answers by indexing it.

Tolerances of ``assert_history_close``: ``num_scheduled`` and
``avail_count`` exact; energy rtol 1e-5 (a different selected set would
move it by a whole client's upload, far more); ``min_battery`` rtol 1e-5
or 4 ulps of the budget it was taken from, whichever is larger (budget
minus the uploads paid: where a battery nearly drains the difference
cancels, and its error stays that of the budget's subtractions); λ atol
1e-6 and loss rtol 1e-4 (f32 summation order differs between XLA and
torch); accuracies within one test sample of one client (1 / S_test),
since a logit near a tie may flip one prediction. ``assert_run_close``
adds the rule for a battery gate or GCA threshold decided differently at
a near-tie (``_torch_compare``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_compare import first_discrete_divergence, head, near_tie
from repro.core.channel import client_keys
from repro.core.transport import _client_uniforms
from repro_torch.core.draws import IdDraws, InitDraws, RoundDraws, RoundStreams, Stream


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _reference_round(key, n, b, draw_sc, shard, leaf_shapes, quantized,
                     temporal):
    """One round of the reference's key discipline (``simulator.py``
    round_fn and ``dynamics.step_process``): the 7-way split and every
    draw made from it."""
    key, k_chan, k_sel, k_batch, k_noise, k_asel, k_abatch = jax.random.split(key, 7)
    keys = jax.random.split(k_noise, len(leaf_shapes))
    noise = jnp.concatenate([jax.random.normal(kk, s).reshape(-1)
                             for kk, s in zip(keys, leaf_shapes)])
    quant_uniform = (_client_uniforms(k_noise, jnp.arange(n), noise.shape[0])
                     if quantized else None)
    walk = (jax.random.normal(jax.random.fold_in(k_chan, 2), (n,))
            if temporal else None)
    avail = (jax.random.uniform(jax.random.fold_in(k_chan, 3), (n,))
             if temporal else None)
    return key, (jax.random.normal(k_chan, (2, n, draw_sc)),
                 jax.random.normal(jax.random.fold_in(k_chan, 1), (n, 1)),
                 jax.random.gumbel(k_sel, (n,)),
                 jax.random.randint(k_batch, (n, b), 0, shard),
                 noise,
                 jax.random.gumbel(k_asel, (n,)),
                 jax.random.randint(k_abatch, (n, b), 0, shard),
                 quant_uniform, walk, avail)


def reference_draws(fl, seed, shard, leaf_shapes):
    """The reference's per-round random numbers, as ``RoundDraws``.

    ``leaf_shapes``: the model's parameter shapes in JAX's sorted-key order
    (the per-leaf AWGN keys follow it). Greedy draws no selection Gumbel, a
    noise-free config no AWGN, a transport other than quantized no
    rounding uniforms and a static run no process draws, so those slots are
    None."""
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(fl.rounds):
        key, vals = _reference_round(key, fl.num_clients, fl.batch_size,
                                     draw_sc, shard, tuple(leaf_shapes),
                                     fl.transport == "quantized", fl.temporal)
        d = RoundDraws(*(None if v is None else torch.from_numpy(np.array(v))
                         for v in vals))
        out.append(d._replace(
            sel_gumbel=None if fl.method == "greedy" else d.sel_gumbel,
            noise=None if fl.noise_std == 0 else d.noise))
    return out


def reference_init_draws(fl, seed):
    """The reference's initial draws of a run seeded with ``seed``
    (``simulator.init_sim_state``), as ``InitDraws``."""
    if not fl.temporal:
        return InitDraws()
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    fast = jax.random.normal(jax.random.fold_in(k_init, 1),
                             (2, fl.num_clients, draw_sc))
    return InitDraws(torch.from_numpy(np.array(fast)))


def battery_atol(budget) -> float:
    """4 ulps of a finite f32 battery budget (0 for an unlimited one)."""
    b = np.float32(budget)
    return float(4 * np.spacing(b)) if np.isfinite(b) else 0.0


def assert_history_close(port, ref, s_test, budget=float("inf")):
    """Port vs reference histories; names the first round that diverges.
    ``budget``: the runs' ``battery_init``."""
    checks = [("num_scheduled", dict(rtol=0, atol=0)),
              ("avail_count", dict(rtol=0, atol=0)),
              ("min_battery", dict(rtol=1e-5, atol=battery_atol(budget))),
              ("energy", dict(rtol=1e-5, atol=0)),
              ("dl_energy", dict(rtol=1e-5, atol=0)),
              ("lam", dict(rtol=0, atol=1e-6)),
              ("lam_max", dict(rtol=0, atol=1e-6)),
              ("lam_ess", dict(rtol=1e-5, atol=0)),
              ("lam_entropy", dict(rtol=1e-5, atol=0)),
              ("loss", dict(rtol=1e-4, atol=0)),
              ("avg_acc", dict(rtol=0, atol=1.0 / s_test + 1e-6)),
              ("worst_acc", dict(rtol=0, atol=1.0 / s_test + 1e-6)),
              ("std_acc", dict(rtol=0, atol=1.0 / s_test + 1e-6))]
    for field, tol in checks:
        a = np.asarray(getattr(port, field), np.float64)
        b = np.asarray(getattr(ref, field), np.float64)
        assert a.shape == b.shape, (field, a.shape, b.shape)
        bad = ~np.isclose(a, b, **tol)
        if bad.any():
            r = int(np.argmax(bad.reshape(bad.shape[0], -1).any(axis=1)))
            raise AssertionError(
                f"{field} diverges first at row {r}: port {a[r]} vs ref {b[r]}")


def assert_run_close(port, ref, s_test, log=None, cell=None,
                     budget=float("inf")):
    """``assert_history_close``, except where a discrete field diverges at
    a compare within 4 ulps of a tie in the port's run (``log``, a
    ``_torch_compare.CompareLog``; ``cell``: this run's row in it): then
    the round and the compare's sides are printed and the histories are
    held to their tolerances up to that round. Returns that round (None:
    none)."""
    r = first_discrete_divergence(port, ref)
    if r is None:
        assert_history_close(port, ref, s_test, budget)
        return None
    assert near_tie(log, r, cell), f"discrete fields diverge at round {r}"
    assert_history_close(head(port, r), head(ref, r), s_test, budget)
    return r


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _client_table(key, n, kind, shape):
    """A full-N per-id table of the sharded control plane's draws: row c
    from ``fold_in(key, c)`` (``channel.client_keys``)."""
    keys = client_keys(key, jnp.arange(n, dtype=jnp.int32))
    if kind == "normal":
        return jax.vmap(lambda k: jax.random.normal(k, shape))(keys)
    if kind == "uniform":
        return jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)
    if kind == "gumbel":
        return jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys)
    high, shape = shape[0], shape[1:]
    return jax.vmap(lambda k: jax.random.randint(k, shape, 0, high))(keys)


class ReferenceStream(Stream):
    """One JAX key of the reference's per-id discipline: a draw fills the
    key's [N, ...] table once and answers rows ``ids``."""

    def __init__(self, key, n):
        self.key, self.n, self.tables = key, n, {}

    def fold(self, i):
        return ReferenceStream(jax.random.fold_in(self.key, i), self.n)

    def _rows(self, kind, shape, ids):
        if (kind, shape) not in self.tables:
            self.tables[kind, shape] = torch.from_numpy(np.array(
                _client_table(self.key, self.n, kind, tuple(shape))))
        return self.tables[kind, shape][ids.long().cpu()].to(ids.device)

    def normal(self, ids, shape=()):
        return self._rows("normal", tuple(shape), ids)

    def uniform(self, ids, shape=()):
        return self._rows("uniform", tuple(shape), ids)

    def gumbel(self, ids):
        return self._rows("gumbel", (), ids)

    def randint(self, ids, shape, high):
        return self._rows("randint", (high, *shape), ids)


class ReferenceIdDraws(IdDraws):
    """The reference's sharded-plane randomness of a run seeded with
    ``seed`` as an ``IdDraws``: the simulator's key chain
    (``split(PRNGKey(seed))[1]`` first, ``init_sim_state``) or, with
    ``server=True``, the parameter server's (``PRNGKey(seed)`` itself); the
    initial state from ``fold_in(split(PRNGKey(seed))[0], 1)`` either way.
    ``leaf_shapes``: the model's parameter shapes in sorted-key order, for
    the per-leaf AWGN of ``aircomp.flat_awgn``."""

    def __init__(self, fl, seed, leaf_shapes, server=False):
        k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
        self.n, self.leaf_shapes = fl.num_clients, tuple(leaf_shapes)
        self.k_cs = jax.random.fold_in(k_init, 1)
        key = jax.random.PRNGKey(seed) if server else k_run
        self.rounds = []
        for _ in range(fl.rounds):
            key, *roles = jax.random.split(key, 7)
            self.rounds.append(roles)

    def round(self, t):
        k_chan, k_sel, k_batch, k_noise, k_asel, k_abatch = self.rounds[t]
        streams = [ReferenceStream(k, self.n)
                   for k in (k_chan, k_sel, k_batch, k_noise, k_asel, k_abatch)]
        shapes = self.leaf_shapes

        def awgn(model_size):
            keys = jax.random.split(k_noise, len(shapes))
            z = np.concatenate([np.asarray(jax.random.normal(k, s)).reshape(-1)
                                for k, s in zip(keys, shapes)])
            assert z.shape[0] == model_size
            return torch.from_numpy(z)

        return RoundStreams(*streams, awgn=awgn)

    def init(self):
        return ReferenceStream(self.k_cs, self.n)
