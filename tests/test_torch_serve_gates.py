"""The card-vs-CPU serve checks of ``chip_smoke.py``, fed hand-made inputs on
the CPU, and what they rely on.

``router_flips`` explains a router top-k set taken apart only within
ROUTER_FLIP_FACTOR (100) × the row's probability delta of a tie, and
refuses logs that do not hold one call a layer for the prefill and each
decode step; ``RouterLog`` sees every call of a real MoE serve.
``compare_serves`` holds every position to SERVE_DLOGIT_LIMIT (1e-3) except
the rows left out after a flip and the positions an f64 run explained;
``judge_f64`` explains a position only where the CPU's f32 lies past the
same limit from the f64 run and the card no farther from it (no farther
than a stated factor times, where a check asks for one), and records the
plain-kernel witness runs beside it; ``plain_kernels`` swaps the kernels'
entry points for their plain versions and back. The f64
run is f64 throughout: RoPE, the SSD scan and step, and the logits keep
f64 in f64 (checked against numpy f64 at rtol 1e-12), and f32 inputs still
compute in f32. The launcher's one-card depth cuts are one table.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CFG = types.SimpleNamespace(name="moe-test", experts_per_token=2, num_layers=1)


def router_call(probs):
    """One router call's (top-k ids [1, 1, k], probabilities [1, 1, E])."""
    probs = torch.tensor([[probs]], dtype=torch.float32)
    return torch.topk(probs, CFG.experts_per_token, dim=-1).indices, probs


def test_router_flip_within_the_rule_leaves_its_row_out(smoke):
    cpu = [router_call([0.4, 0.3, 0.29999, 0.00001]), router_call([0.5, 0.3, 0.2, 0.0])]
    # the card's third expert 2e-6 above its second: a gap of 1e-5 on the CPU
    card = [router_call([0.4, 0.299995, 0.299997, 0.000008]), cpu[1]]
    flips, left_out = smoke.router_flips(torch, CFG, card, cpu, prompt=1, gen=2)
    assert len(flips) == 1 and flips[0]["step"] == 0 and flips[0]["cpu"] == [0, 1]
    assert flips[0]["card"] == [0, 2]
    assert flips[0]["gap"] <= smoke.ROUTER_FLIP_FACTOR * flips[0]["prob_delta"]
    assert left_out == {0: 0}


def test_router_flip_outside_the_rule_fails(smoke):
    cpu = [router_call([0.4, 0.3, 0.2, 0.1]), router_call([0.5, 0.3, 0.2, 0.0])]
    # the card picks expert 2 over 1, which the CPU puts 0.1 below it, with
    # probabilities 1e-6 from the CPU's
    card = [cpu[0], (torch.tensor([[[0, 2]]]), cpu[1][1] + 1e-6)]
    with pytest.raises(AssertionError, match="unexplained"):
        smoke.router_flips(torch, CFG, card, cpu, prompt=1, gen=2)


@pytest.mark.parametrize("card_n,cpu_n", [(0, 0), (1, 1), (2, 1), (3, 3)])
def test_router_flips_refuses_logs_of_the_wrong_length(smoke, card_n, cpu_n):
    call = router_call([0.4, 0.3, 0.2, 0.1])
    with pytest.raises(AssertionError, match="router calls"):
        smoke.router_flips(torch, CFG, [call] * card_n, [call] * cpu_n, prompt=1, gen=2)


def test_router_log_sees_every_router_call_of_a_serve(smoke):
    cfg = serve.serve_config("qwen3-moe-30b-a3b", reduced=True)
    model = build_model(cfg)
    params = serve.init_params(model, 0, "cpu")
    tokens = serve.prompt_tokens(cfg, 2, 8, 0, "cpu")
    with smoke.RouterLog() as log:
        serve.generate(model, params, tokens, 3)
    assert len(log.calls) == cfg.num_layers * 3
    assert [tuple(i.shape) for i, _ in log.calls] == (
        [(2, 8, cfg.experts_per_token)] * cfg.num_layers
        + [(2, 1, cfg.experts_per_token)] * 2 * cfg.num_layers)


def logits_pair(card_delta):
    """CPU logits [2 rows, 4] over 2 steps with a top-2 margin of 1; the
    card's the same plus ``card_delta`` {(step, row): Δ} on column 3."""
    cpu = [torch.tensor([[3.0, 2.0, 0.0, -1.0], [0.0, 3.0, 2.0, -1.0]]) for _ in range(2)]
    card = [c.clone() for c in cpu]
    for (i, r), d in card_delta.items():
        card[i][r, 3] += d
    toks = torch.tensor([[0, 0], [1, 1]])
    return card, cpu, toks


def test_compare_serves_holds_every_position_to_the_limit(smoke):
    card, cpu, toks = logits_pair({(1, 0): 5e-4})
    steps, compared, positions = smoke.compare_serves(torch, "t", card, cpu, toks, toks)
    assert (compared, positions) == (4, 4)
    assert steps[1]["max_abs_dlogit"] == pytest.approx(5e-4, rel=1e-3)   # f32 rounding
    card, cpu, toks = logits_pair({(1, 0): 1.5e-3})
    with pytest.raises(AssertionError, match="step 1 max"):
        smoke.compare_serves(torch, "t", card, cpu, toks, toks)
    card[0][1, 0] = float("nan")
    assert smoke.over_limit(card, cpu, {}) == [(0, 1), (1, 0)]


def test_compare_serves_skips_only_left_out_and_explained_positions(smoke):
    card, cpu, toks = logits_pair({(1, 0): 1.5e-3})
    smoke.compare_serves(torch, "t", card, cpu, toks, toks, left_out={0: 1})
    smoke.compare_serves(torch, "t", card, cpu, toks, toks, explained={(1, 0)})
    with pytest.raises(AssertionError):   # a left-out row from a later step
        smoke.compare_serves(torch, "t", card, cpu, toks, toks, left_out={0: 2})
    with pytest.raises(AssertionError):   # another position explained
        smoke.compare_serves(torch, "t", card, cpu, toks, toks, explained={(1, 1)})
    assert smoke.over_limit(card, cpu, {0: 1}) == []
    assert smoke.over_limit(card, cpu, {}) == [(1, 0)]


@pytest.mark.parametrize("card_f64,cpu_f64,explained", [
    (4e-5, 1.54e-3, True),     # the card near exact, the CPU's f32 off
    (1.05e-3, 2.62e-3, True),  # both past the limit, the card nearer
    (6e-3, 1.5e-3, False),     # the card farther from exact than the CPU
    (2.7e-3, 2.6e-3, False),   # both past the limit, the card farther
    (5e-4, 9e-4, False),       # the CPU within the limit of exact
])
def test_judge_f64_holds_the_card_to_the_limit_from_exact(smoke, card_f64, cpu_f64,
                                                          explained):
    exact = [torch.zeros((1, 4), dtype=torch.float64)]
    card = [torch.tensor([[0.0, card_f64, 0.0, 0.0]], dtype=torch.float32)]
    cpu = [torch.tensor([[0.0, -cpu_f64, 0.0, 0.0]], dtype=torch.float32)]
    if explained:
        found = smoke.judge_f64("t", [(0, 0)], card, cpu, exact)
        assert found[0]["card_f64"] == pytest.approx(card_f64, rel=1e-6)
        assert found[0]["cpu_f64"] == pytest.approx(cpu_f64, rel=1e-6)
    else:
        with pytest.raises(AssertionError, match="unexplained"):
            smoke.judge_f64("t", [(0, 0)], card, cpu, exact)


@pytest.mark.parametrize("card_f64,factor,explained", [
    (1.52e-3, 1.0, False),   # the vlm cut's position: farther than the CPU
    (1.52e-3, 2.0, True),    # ... within twice the CPU's distance
    (2.2e-3, 2.0, False),    # past twice the CPU's distance
])
def test_judge_f64_factor_and_plain_witnesses(smoke, card_f64, factor, explained):
    """The CPU 1.05e-3 from exact; the card's witness runs (plain attention
    1.1e-3 from exact, every kernel plain 9e-4) recorded, judging
    nothing."""
    exact = [torch.zeros((1, 4), dtype=torch.float64)]
    card = [torch.tensor([[0.0, card_f64, 0.0, 0.0]], dtype=torch.float32)]
    cpu = [torch.tensor([[0.0, -1.05e-3, 0.0, 0.0]], dtype=torch.float32)]
    plain = {"plain_attention": [torch.tensor([[0.0, -1.1e-3, 0.0, 0.0]])],
             "plain_kernels": [torch.tensor([[0.0, 9e-4, 0.0, 0.0]])]}
    if not explained:
        with pytest.raises(AssertionError, match="unexplained"):
            smoke.judge_f64("t", [(0, 0)], card, cpu, exact, factor, plain)
        return
    (found,) = smoke.judge_f64("t", [(0, 0)], card, cpu, exact, factor, plain)
    assert found["factor"] == factor
    assert found["plain_attention_f64"] == pytest.approx(1.1e-3, rel=1e-6)
    assert found["plain_attention_cpu"] == pytest.approx(0.05e-3, rel=1e-4)
    assert found["plain_kernels_f64"] == pytest.approx(9e-4, rel=1e-6)
    assert found["plain_kernels_cpu"] == pytest.approx(1.95e-3, rel=1e-5)
    assert found["plain_attention_card"] == pytest.approx(card_f64 + 1.1e-3, rel=1e-5)


def test_plain_kernels_swaps_the_kernels_for_their_plain_versions(smoke):
    """Within ``plain_kernels`` the kernels' entry points compute what the
    CPU's wrappers do (flattened heads over [BHkv, G] groups; the RMSNorm
    rows), and on leaving the kernels' own are back."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    own = flash_ops.flash_attention_cuda, rms_ops.rmsnorm_cuda
    gen = torch.Generator().manual_seed(0)
    b, s, t, hkv, g, d = 2, 5, 7, 2, 3, 8
    q = torch.randn((b, s, hkv, g, d), generator=gen)
    k, v = (torch.randn((b, t, hkv, d), generator=gen) for _ in range(2))
    x, scale = torch.randn((6, 16), generator=gen), torch.randn((16,), generator=gen)
    kh, vh = (y.permute(0, 2, 1, 3).reshape(b * hkv, t, d) for y in (k, v))
    with smoke.plain_kernels(("flash_attention", "rmsnorm")):
        for rows, causal in ((s, False), (s, True), (1, False)):
            want = flash_ops.flash_attention(q[:, :rows], k, v, causal=causal)   # the CPU's
            qh = q[:, :rows].permute(0, 2, 3, 1, 4).reshape(b * hkv * g, rows, d)
            got = flash_ops.flash_attention_cuda(qh, kh, vh, group=g, causal=causal,
                                                 window=None)
            torch.testing.assert_close(got.reshape(b, hkv, g, rows, d).permute(0, 3, 1, 2, 4),
                                       want, rtol=0, atol=0)
        torch.testing.assert_close(rms_ops.rmsnorm_cuda(x, scale, 1e-5),
                                   rms_ops.rmsnorm(x, scale, 1e-5), rtol=0, atol=0)
    assert (flash_ops.flash_attention_cuda, rms_ops.rmsnorm_cuda) == own


@pytest.mark.parametrize("moved,explained", [("cpu", True), ("card", False)])
def test_ill_conditioned_runs_the_f64_witness_end_to_end(smoke, moved, explained):
    """A reduced MoE serve on the CPU as both sides, one side's logits
    moved by 2e-3 at one position: moving the CPU's is explained by the
    f64 run (the CPU past the limit from it, the card near it), moving the
    card's is not. A vocabulary of 500 pads the logits to 512 columns, whose
    -1e30 differs between f32 and f64."""
    import copy
    cfg = serve.serve_config("qwen3-moe-30b-a3b", reduced=True).with_(vocab_size=500)
    model = build_model(cfg)
    params = serve.init_params(model, 0, "cpu")
    tokens = serve.prompt_tokens(cfg, 2, 8, 0, "cpu")
    run = serve.generate(model, params, tokens, 3, keep_logits=True)
    logits = [lg.clone() for lg in run.logits]
    logits[1][0, 5] += 2e-3
    sides = {"cpu": run, "card": run}
    sides[moved] = run._replace(logits=logits)
    if explained:
        found = smoke.ill_conditioned(torch, cfg, copy.deepcopy(params), tokens,
                                      sides["cpu"], sides["card"], {})
        assert [(x["step"], x["row"]) for x in found] == [(1, 0)]
        assert found[0]["card_f64"] <= smoke.SERVE_DLOGIT_LIMIT < found[0]["cpu_f64"]
    else:
        with pytest.raises(AssertionError, match="unexplained"):
            smoke.ill_conditioned(torch, cfg, copy.deepcopy(params), tokens,
                                  sides["cpu"], sides["card"], {})


def test_rope_keeps_f64_in_f64():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)) * 30
    pos = np.arange(37, 42)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.float64
    freqs = 1.0 / 1e6 ** (np.arange(0, 8, 2) / 8)
    ang = pos[:, None, None] * freqs
    x1, x2 = x[..., :4], x[..., 4:]
    want = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                           x1 * np.sin(ang) + x2 * np.cos(ang)], -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    f32 = layers.apply_rope(torch.from_numpy(x).float(), torch.from_numpy(pos), 1e6)
    assert f32.dtype == torch.float32
    assert not np.allclose(f32.numpy(), want, rtol=1e-9, atol=1e-9)


def test_ssd_scan_and_step_keep_f64_in_f64():
    rng = np.random.default_rng(1)
    b, s, h, p, n = 2, 7, 3, 4, 5
    xh, bm, cm = (torch.from_numpy(rng.normal(size=sh))
                  for sh in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.from_numpy(rng.uniform(0.1, 1.0, size=(b, s, h)))
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, size=h))
    y, state = ssm.ssd_scan(xh, dt, a, bm, cm, chunk=3)
    assert y.dtype == state.dtype == torch.float64
    # the plain recurrence in numpy f64
    st = np.zeros((b, h, n, p))
    want = []
    for t in range(s):
        st = (np.exp(dt[:, t].numpy() * a.numpy())[..., None, None] * st
              + np.einsum("bn,bhp->bhnp", bm[:, t].numpy(),
                          xh[:, t].numpy() * dt[:, t].numpy()[..., None]))
        want.append(np.einsum("bn,bhnp->bhp", cm[:, t].numpy(), st))
    np.testing.assert_allclose(y.numpy(), np.stack(want, 1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(state.numpy(), st, rtol=1e-12, atol=1e-12)
    state0 = torch.zeros((b, h, n, p), dtype=torch.float64)
    y1 = ssm.ssd_step(state0, xh[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    assert y1.dtype == torch.float64
    np.testing.assert_allclose(y1.numpy(), want[0], rtol=1e-12, atol=1e-12)
    y32, state32 = ssm.ssd_scan(xh.float(), dt.float(), a.float(), bm.float(), cm.float(), 3)
    assert y32.dtype == state32.dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_an_f64_model_serves_f64_logits(arch):
    cfg = serve.serve_config(arch, reduced=True).with_(dtype="float64")
    model = build_model(cfg)
    params = serve.init_params(model, 0, "cpu")
    res = serve.generate(model, params, serve.prompt_tokens(cfg, 1, 5, 0, "cpu"), 2,
                         keep_logits=True)
    assert all(lg.dtype == torch.float64 for lg in res.logits)
    assert all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()) for lg in res.logits)


def test_one_card_depth_cuts_are_the_launchers_table(smoke):
    from repro_torch.configs import get_config, get_reduced
    for arch, layers_ in serve.ONE_CARD_LAYERS.items():
        assert serve.serve_config(arch).num_layers == layers_ < get_config(arch).num_layers
        assert serve.serve_config(arch, reduced=True).num_layers == get_reduced(
            arch).num_layers
    assert serve.serve_config("zamba2-1.2b").num_layers == 38
    assert not hasattr(smoke, "SERVE_CUTS")
