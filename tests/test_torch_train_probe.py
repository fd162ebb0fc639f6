"""The zoo's probe paths on the parameter server, on the CPU: GCA's
per-client gradient probe and the quantized and sparse transports' delta
probe on the reduced qwen2-0.5b and xlstm-1.3b (f32, the reference's
weights carried into the port), against the JAX package.

- The probe (``rounds.make_grad_norm_probe``, a ``torch.func.vmap`` through
  the kernels' autograd.Functions) against the reference's (a
  ``lax.scan`` over the clients), with and without the gradient rows, the
  client blocks permuted; and two chunk sizes of the port's giving the same
  outputs bit for bit.
- Three steps of ``ParameterServer`` under GCA (probe reuse on and off),
  ca_afl quantized and ca_afl sparse against the reference's server, each
  step from the reference's state (``_torch_train_reference.both_servers``).

Tolerances. The probe: norms and losses rtol 1e-4, each flat row within
1e-4 of its largest entry. The server: ``num_scheduled`` exactly, energy
rtol 1e-5, λ atol 1e-6, loss rtol 1e-4, each parameter leaf within 5e-4 of
its largest move in the step (as ``test_torch_train_server.py``). The two
frameworks' gradients lie ~1e-4 apart relative, so a stochastic rounding
or a top-k membership may be decided apart: that is allowed only within
its tie bound (``_torch_compare.decisions_apart``) at the rows' agreement
(``ROW_AGREE``, itself held), and only at the coordinates it moves, by as
much as it moves them; a decision within 2⁻¹² of a grid point or 1e-5 of
the threshold counts as taken apart (the two implementations' roundings
differ at exact ties even on the same rows). The sparse residual is held
within 5e-4 of each row's largest delta beside those moves, and λ at 1e-6
beside those moves' first-order effect on the clients' losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_compare import decisions_apart  # noqa: E402
from _torch_train_reference import (assert_states_close, both_servers, configs,  # noqa: E402
                                    reference_run)
from repro_torch.federated import rounds  # noqa: E402
from repro_torch.models import api, dense, xlstm  # noqa: E402

ARCHS = {"qwen2-0.5b": {}, "xlstm-1.3b": {"ssm_chunk": 16}}
N = 4
STEPS = 3
# the per-client gradient rows of the two frameworks agree to this share
# of each row's largest entry (measured on these runs: ≤ 1e-4 at the
# reference's init, up to 6.3e-4 on qwen2-0.5b after two quantized steps)
ROW_AGREE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FL_KW = dict(num_clients=N, clients_per_round=2, rounds=STEPS, energy_C=8.0, noise_std=1e-3,
             seed=0)
# the reference's server a path: GCA with probe reuse (the same steps as
# without, up to summation order, so the port's GCA with and without reuse
# are both held against it), ca_afl quantized and ca_afl sparse, the last
# two taking over GCA's jitted probe and loss probe
REF_PATHS = {"gca": dict(method="gca"), "quantized": dict(transport="quantized"),
             "sparse": dict(transport="sparse")}
_RUNS = {}


def _run(arch, path):
    """The reference's STEPS steps of ``path`` on ``arch``, made once."""
    if (arch, path) not in _RUNS:
        share = None if path == "gca" else _run(arch, "gca")[0]
        _RUNS[arch, path] = reference_run(arch, {**FL_KW, **REF_PATHS[path]}, STEPS,
                                          share=share, **ARCHS[arch])
    return _RUNS[arch, path]


def _probe_inputs(arch):
    """(port model, its params, the reference's jitted with-grads probe, its
    params, a batch with its client blocks permuted): the reference's
    initial state and first batch of its GCA run."""
    ref, run = _run(arch, "gca")
    rs0, _, batch, _ = run[0]
    _, tcfg = configs(arch, **ARCHS[arch])
    family = dense if tcfg.family == "dense" else xlstm
    params = api.Model.train_params(family.params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, rs0.params), "cpu"))
    order = (np.array([2, 0, 3, 1])[:, None] * 2 + np.arange(2)).reshape(-1)
    batch = {k: v[order] for k, v in batch.items()}
    return api.build_model(tcfg), params, ref._grad_probe, rs0.params, batch


def _rows_close(got, want, tol=1e-4):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        lim = tol * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= lim, (i, float(np.abs(g - w).max()), lim)


@pytest.mark.parametrize("with_grads", [False, True], ids=["norms", "with_grads"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_probe_matches_reference(arch, with_grads):
    """The reference's probe with the rows: its norms are the square root of
    each flat row's sum of squares, the same norms as without the rows up
    to summation order."""
    tm, params, jprobe, jparams, batch = _probe_inputs(arch)
    got = rounds.make_grad_norm_probe(tm, N, with_grads=with_grads)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jprobe(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = got if with_grads else (got,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4)
    assert bool((got[0] > 0).all())
    if with_grads:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
        assert got[2].shape == (N, sum(p.numel() for p in params.values()))
        _rows_close(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_probe_does_not_depend_on_its_chunk(arch, monkeypatch):
    """One client a chunk, three (a chunk of 3 and one of 1) and all four
    (``rounds.PROBE_CHUNK_BYTES`` set to that many clients' rows): the same
    norms, losses and rows, bit for bit."""
    tm, params, _, _, batch = _probe_inputs(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    row_bytes = 4 * sum(p.numel() for p in params.values())

    def probe(chunk, with_grads=True):
        monkeypatch.setattr(rounds, "PROBE_CHUNK_BYTES", chunk * row_bytes)
        assert rounds.probe_chunk(row_bytes // 4, N) == chunk
        return rounds.make_grad_norm_probe(tm, N, with_grads=with_grads)(params, tb)
    outs = [probe(c) for c in (1, 3, N)]
    for out in outs[1:]:
        for a, b in zip(outs[0], out, strict=True):
            assert torch.equal(a, b)
    assert torch.equal(probe(3, with_grads=False), outs[0][0])


def test_probe_chunk_rule():
    assert rounds.probe_chunk(630_396_800, 8) == 4     # qwen2-0.5b
    assert rounds.probe_chunk(2_221_906_256, 8) == 1   # xlstm-1.3b
    assert rounds.probe_chunk(543_334_456, 8) == 4     # xlstm-1.3b at 8 layers
    assert rounds.probe_chunk(10_000, 8) == 8


# (the reference's run, the port's probe reuse)
PATHS = {"gca_reuse": ("gca", True), "gca_no_reuse": ("gca", False),
         "quantized": ("quantized", True), "sparse": ("sparse", True)}


def _flat(params):
    """The reference's params as one flat row, leaves in the port's order."""
    return torch.cat([torch.from_numpy(np.asarray(leaf)).reshape(-1)
                      for leaf in jax.tree_util.tree_leaves(params)])


def _payload_rows(port, ref, ps0, rs0, batch):
    """The step's per-client gradient rows of both servers (their delta
    probes at the same params and batch), as f32 tensors."""
    g_port = port._delta_probe(ps0.params, {k: torch.from_numpy(v) for k, v in batch.items()})[2]
    g_ref = ref._delta_probe(rs0.params, {k: jnp.asarray(v) for k, v in batch.items()})[2]
    return g_port, torch.from_numpy(np.array(g_ref))


def _leaves_close(ps, rs, p0, allow, what):
    """Each leaf within 5e-4 of its largest move in the step (plus 1e-7),
    and beside that by ``allow`` at each flat coordinate."""
    want_all, off = _flat(rs.params), 0
    for name in sorted(ps.params):
        size = ps.params[name].numel()
        got, want = ps.params[name].reshape(-1), want_all[off:off + size]
        moved = float((want - torch.from_numpy(p0[name]).reshape(-1)).abs().max())
        lim = 5e-4 * moved + 1e-7 + allow[off:off + size]
        assert bool(((got - want).abs() <= lim).all()), (what, name)
        off += size


def _check_compressed_step(ps, rs, p0, port, ref, ps0, rs0, batch, d):
    """One quantized or sparse step (see the module docstring): the rows'
    agreement, the decisions taken apart only at ties, and the step's
    fields beside the moves of those decisions."""
    fl, t = port.fl, len(rs.history)
    k = rs.history[-1]["num_scheduled"]
    g_port, g_ref = _payload_rows(port, ref, ps0, rs0, batch)
    agree = (g_port - g_ref).abs().amax(dim=1) / g_ref.abs().amax(dim=1)
    assert bool((agree <= ROW_AGREE).all()), (t, agree)
    eta = torch.tensor(fl.lr0 * fl.lr_decay ** rs0.round, dtype=torch.float32)
    sparse = fl.transport == "sparse"
    moved, _, _ = decisions_apart(fl, (-eta) * g_ref, (-eta) * g_port,
                                  u=None if sparse else d.quant_uniform,
                                  resid=ps0.ef_resid if sparse else None, agree=ROW_AGREE,
                                  near=True)
    allow = moved.sum(dim=0) / max(k, 1)
    assert ps.history[-1]["num_scheduled"] == k
    np.testing.assert_allclose(ps.energy_joules, rs.energy_joules, rtol=1e-5)
    np.testing.assert_allclose(ps.history[-1]["loss"], rs.history[-1]["loss"], rtol=1e-4)
    _leaves_close(ps, rs, p0, allow, f"step {t}")
    if sparse:
        want = torch.from_numpy(np.array(rs.ef_resid))
        lim = 5e-4 * (eta * g_ref).abs().amax(dim=1, keepdim=True) + 1e-7 + moved
        assert bool(((ps.ef_resid - want).abs() <= lim).all()), ("ef_resid", t)
    # λ: the clients' losses at the new params move with the decisions'
    # moves by at most Σ_j |∂f_i/∂w_j|·allow_j to first order (taken twice),
    # and the ascent γ·f is projected onto the simplex, nonexpansively
    g_new = port._delta_probe(ps.params, {k_: torch.from_numpy(v) for k_, v in
                                          batch.items()})[2]
    dloss = (g_new.abs() * allow).sum(dim=1)
    lim = 1e-6 + 2 * fl.ascent_lr * float(torch.linalg.vector_norm(dloss))
    err = float((ps.lam - torch.from_numpy(np.array(rs.lam))).abs().max())
    assert err <= lim, ("lam", t, err, lim)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_server_steps_match_reference(arch, path):
    ref_path, reuse = PATHS[path]
    fl_kw = {**FL_KW, **REF_PATHS[ref_path]}
    scheduled = []
    for ps, rs, p0, inputs in both_servers(
            arch, fl_kw, STEPS, reuse_probe_grads=reuse, inputs=True,
            ref_run=_run(arch, ref_path), **ARCHS[arch]):
        if ref_path == "gca":
            assert_states_close(ps, rs, p0, param_tol=5e-4)
        else:
            _check_compressed_step(ps, rs, p0, *inputs)
        scheduled.append(ps.history[-1]["num_scheduled"])
    assert len(scheduled) == STEPS and all(s >= 1 for s in scheduled)
