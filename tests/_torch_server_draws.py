"""The reference parameter server's random numbers as the port's
``RoundDraws`` (shared by the port's server tests).

The reference server starts its key chain at ``PRNGKey(seed)`` with no
initial split (the simulator splits once first, ``_torch_reference``) and
splits it 7 ways a step in the simulator's role order. Its receiver noise
has two disciplines: ``rounds.add_awgn`` (the exact-K rounds and the GCA
apply) splits the noise key once per leaf and draws a leaf with
``ndim >= 2`` and more than 4 rows (the logreg ``w``) one
``fold_in(k_leaf, i)`` row at a time; ``transport.flat_awgn_like`` (the
quantized and sparse applies) draws each leaf at once, the simulator's
discipline.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_reference import _reference_round
from repro_torch.core.draws import RoundDraws

CLS, DIM = 10, 16
LEAF_SHAPES = ((CLS,), (DIM, CLS))   # the test logreg's, sorted-key order: b, w


@functools.partial(jax.jit, static_argnums=1)
def _row_awgn(k_noise, leaf_shapes):
    keys = jax.random.split(k_noise, len(leaf_shapes))
    parts = []
    for k, shape in zip(keys, leaf_shapes):
        if len(shape) >= 2 and shape[0] > 4:
            # row i from fold_in(k, i), all rows at once
            z = jax.vmap(lambda i, k=k, shape=shape: jax.random.normal(
                jax.random.fold_in(k, i), shape[1:]))(jnp.arange(shape[0]))
        else:
            z = jax.random.normal(k, shape)
        parts.append(z.reshape(-1))
    return jnp.concatenate(parts)


def row_awgn(k_noise, leaf_shapes=LEAF_SHAPES) -> np.ndarray:
    """The [P] standard normals that ``rounds.add_awgn`` adds under
    ``k_noise`` (before its σ), in sorted-leaf order (one compiled call a
    set of leaf shapes)."""
    return np.asarray(_row_awgn(k_noise, tuple(tuple(s) for s in leaf_shapes)))


def server_draws(fl, seed, steps, row_noise, leaf_shapes=LEAF_SHAPES):
    """The reference server's random numbers for ``steps`` steps, as
    ``RoundDraws``; ``row_noise``: the noise of ``add_awgn`` (else the
    per-leaf flat draw of the quantized and sparse applies)."""
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        k_noise = jax.random.split(key, 7)[4]
        key, vals = _reference_round(key, fl.num_clients, 1, draw_sc, 1,
                                     tuple(leaf_shapes), fl.transport == "quantized",
                                     fl.temporal)
        d = RoundDraws(*(None if v is None else torch.from_numpy(np.array(v))
                         for v in vals))
        noise = torch.from_numpy(row_awgn(k_noise, leaf_shapes)) if row_noise else d.noise
        out.append(d._replace(
            sel_gumbel=None if fl.method == "greedy" else d.sel_gumbel,
            noise=None if fl.noise_std == 0 else noise))
    return out
