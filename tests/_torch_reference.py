"""Shared helpers of the port's parity tests: the reference's random numbers
as the port's ``RoundDraws``, and the history comparison with the
simulator's tolerances.

``reference_draws`` replays the reference's key discipline with
``jax.random`` (the 7-way per-round split of ``repro/core/simulator.py``,
from ``split(PRNGKey(seed))[1]`` as ``init_sim_state`` takes it), so both
packages see the same channels, Gumbel noise, batches, AWGN and
quantization uniforms (the reference's own ``_client_uniforms`` of the
round's noise key, for all N clients). The reference's sweep seeds cell
(p, s) with ``PRNGKey(s)`` as ``run_simulation(seed=s)`` does, so
``reference_draws(fl_p, s, ...)`` is that cell's stream too.

Tolerances of ``assert_history_close``: ``num_scheduled`` exact; energy
rtol 1e-5 (a different selected set would move it by a whole client's
upload, far more); λ atol 1e-6 and loss rtol 1e-4 (f32 summation order
differs between XLA and torch); accuracies within one test sample of one
client (1 / S_test), since a logit near a tie may flip one prediction.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.transport import _client_uniforms
from repro_torch.core.draws import RoundDraws


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _reference_round(key, n, b, draw_sc, shard, leaf_shapes, quantized):
    """One round of the reference's key discipline (``simulator.py``
    round_fn): the 7-way split and every draw made from it."""
    key, k_chan, k_sel, k_batch, k_noise, k_asel, k_abatch = jax.random.split(key, 7)
    keys = jax.random.split(k_noise, len(leaf_shapes))
    noise = jnp.concatenate([jax.random.normal(kk, s).reshape(-1)
                             for kk, s in zip(keys, leaf_shapes)])
    quant_uniform = (_client_uniforms(k_noise, jnp.arange(n), noise.shape[0])
                     if quantized else None)
    return key, (jax.random.normal(k_chan, (2, n, draw_sc)),
                 jax.random.normal(jax.random.fold_in(k_chan, 1), (n, 1)),
                 jax.random.gumbel(k_sel, (n,)),
                 jax.random.randint(k_batch, (n, b), 0, shard),
                 noise,
                 jax.random.gumbel(k_asel, (n,)),
                 jax.random.randint(k_abatch, (n, b), 0, shard),
                 quant_uniform)


def reference_draws(fl, seed, shard, leaf_shapes):
    """The reference's per-round random numbers, as ``RoundDraws``.

    ``leaf_shapes``: the model's parameter shapes in JAX's sorted-key order
    (the per-leaf AWGN keys follow it). Greedy draws no selection Gumbel, a
    noise-free config no AWGN and a transport other than quantized no
    rounding uniforms, so those slots are None."""
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(fl.rounds):
        key, vals = _reference_round(key, fl.num_clients, fl.batch_size,
                                     draw_sc, shard, tuple(leaf_shapes),
                                     fl.transport == "quantized")
        d = RoundDraws(*(None if v is None else torch.from_numpy(np.array(v))
                         for v in vals))
        out.append(d._replace(
            sel_gumbel=None if fl.method == "greedy" else d.sel_gumbel,
            noise=None if fl.noise_std == 0 else d.noise))
    return out


def assert_history_close(port, ref, s_test):
    """Port vs reference histories; names the first round that diverges."""
    checks = [("num_scheduled", dict(rtol=0, atol=0)),
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
