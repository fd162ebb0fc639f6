"""The reference's ``ParameterServer`` and the port's on a reduced zoo model,
side by side on the CPU (shared by ``test_torch_train_server.py`` and
``test_torch_train_xlstm.py``).

Both start from the reference's initial parameters (carried into the port
by ``params_from_jax``), take the same ``lm_batches`` (the port's copy of
the launcher's, bit-equal to the reference's) and the same random numbers:
the port's ``RoundDraws`` are filled from the reference server's key chain
(``_torch_server_draws.server_draws``), its receiver noise by
``rounds.add_awgn``'s per-leaf discipline (``row_awgn``) over the zoo
model's leaves in sorted order.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_server_draws import server_draws
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FLConfig as JFLConfig
from repro.federated.server import ParameterServer as JServer
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.federated.server import ParameterServer, ServerState
from repro_torch.launch.train import lm_batches
from repro_torch.models import api, dense, xlstm
from repro_torch.optim import sgd

LR = 0.05


def configs(arch, **kw):
    kw = dict(dtype="float32", remat=False, **kw)
    return jax_get_reduced(arch).with_(**kw), get_reduced(arch).with_(**kw)


def reference_run(arch, fl_kw, steps, seed=0, seq=16, per_client=2, reuse_probe_grads=True,
                  share=None, **cfg_kw):
    """``steps`` steps of the reference's server on ``arch``'s reduced
    config and the launcher's batches: (the server, [(state before, state
    after, the batch, the port's ``RoundDraws`` of the step)]). The draws
    follow each path's receiver-noise discipline: ``add_awgn``'s rows for
    the rounds and the GCA apply, the per-leaf flat draw for the quantized
    and sparse applies. ``share``: a reference server of the same config
    whose jitted with-grads probe and loss probe this one takes over, so
    that each is compiled once a config."""
    jcfg, tcfg = configs(arch, **cfg_kw)
    jfl, fl = JFLConfig(**fl_kw), FLConfig(**fl_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        ref = JServer(japi.build_model(jcfg), jsgd(LR), jfl, seed=seed,
                      reuse_probe_grads=reuse_probe_grads)
    if share is not None:
        probe = share._grad_probe or share._delta_probe
        for attr in ("_grad_probe", "_delta_probe"):
            if getattr(ref, attr) is not None:
                setattr(ref, attr, probe)
        ref._loss_probe = share._loss_probe
    rs = ref.init_state(jax.random.PRNGKey(seed))
    shapes = [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(rs.params)]
    draws = server_draws(fl, seed, steps, leaf_shapes=shapes,
                         row_noise=fl.transport not in ("quantized", "sparse"))
    corpus = make_lm_tokens(fl.num_clients, 256, tcfg.vocab_size, seed=seed)
    batches = lm_batches(corpus, per_client, seq, tcfg, seed)
    run = []
    for d in draws:
        batch = next(batches)
        new = ref.step(rs, {k: jnp.asarray(v) for k, v in batch.items()})
        # the server appends to one history list: keep this step's rows
        run.append((rs, dataclasses.replace(new, history=list(new.history)), batch, d))
        rs = new
    return ref, run


def both_servers(arch, fl_kw, steps, seed=0, reuse_probe_grads=True, inputs=False,
                 ref_run=None, **cfg_kw):
    """``steps`` steps of both servers on ``arch``'s reduced config (the
    reference's from :func:`reference_run`, or ``ref_run`` made by it), the
    port's each from the reference's state before it (params, λ, the energy
    ledger and the sparse residual carried across: the reference's init
    grows the residual stream to ~5e3, so SGD at lr 0.05 amplifies the two
    frameworks' rounding from step to step, and a step is checked on its
    own); yields (port state, reference state, the params before the step
    as numpy) after each, and with ``inputs`` a fourth item: (the port
    server, the reference server, the two states before the step, the
    batch, the port's draws)."""
    ref, run = ref_run or reference_run(arch, fl_kw, steps, seed,
                                        reuse_probe_grads=reuse_probe_grads, **cfg_kw)
    _, tcfg = configs(arch, **cfg_kw)
    fl = FLConfig(**fl_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = ParameterServer(api.build_model(tcfg), sgd(LR), fl, seed=seed,
                               reuse_probe_grads=reuse_probe_grads, device="cpu")
    family = dense if tcfg.family == "dense" else xlstm
    opt = sgd(LR)
    history = []
    for rs_before, rs, batch, d in run[:steps]:
        np_params = jax.tree_util.tree_map(np.asarray, rs_before.params)
        params = api.Model.train_params(family.params_from_jax(tcfg, np_params, "cpu"))
        p0 = {name: v.numpy().copy() for name, v in params.items()}
        resid = (torch.from_numpy(np.array(rs_before.ef_resid)) if fl.transport == "sparse"
                 else ())
        ps_before = ServerState(
            params=params, opt_state=opt.init(params, "cpu"),
            lam=torch.from_numpy(np.array(rs_before.lam)), round=rs_before.round,
            energy_joules=rs_before.energy_joules, history=history,
            dl_energy_joules=rs_before.dl_energy_joules, ef_resid=resid)
        ps = port.step(ps_before, batch, d)
        history = ps.history
        if inputs:
            yield ps, rs, p0, (port, ref, ps_before, rs_before, batch, d)
        else:
            yield ps, rs, p0


def assert_states_close(ps, rs, p0, param_tol):
    """num_scheduled exactly, energy rtol 1e-5, λ atol 1e-6, the round's
    loss rtol 1e-4; every parameter leaf within ``param_tol`` times its
    largest move from ``p0`` in the reference's step (plus 1e-7): a step
    is lr·g, and the gradients agree to a share of their largest entries."""
    t = len(rs.history)
    for key in ("num_scheduled", "round"):
        assert ps.history[-1][key] == rs.history[-1][key], (key, t)
    np.testing.assert_allclose(ps.energy_joules, rs.energy_joules, rtol=1e-5)
    np.testing.assert_allclose(ps.lam.numpy(), np.asarray(rs.lam), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ps.history[-1]["loss"], rs.history[-1]["loss"], rtol=1e-4)
    leaves = jax.tree_util.tree_leaves(rs.params)
    for name, want in zip(sorted(ps.params), leaves, strict=True):
        want = np.asarray(want)
        moved = float(np.abs(want - p0[name]).max())
        np.testing.assert_allclose(ps.params[name].numpy(), want, rtol=0,
                                   atol=param_tol * moved + 1e-7, err_msg=f"{name} step {t}")

