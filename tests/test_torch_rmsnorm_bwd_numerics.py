"""The RMSNorm backward kernel's order of sums, emulated on the CPU in plain
f32, against JAX and against an f64 sum.

``rmsnorm_bwd`` (``src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu``)
runs on the card alone. What fixes its result is the order of its sums,
and that order comes from the shape through ``kernel.bwd_blocks`` and
``kernel.bwd_warps_a_row``: G warps a row, 8 / G rows (slots) a block at
once, blocks of ⌈R / blocks⌉ consecutive rows, slot s of a block walking
rows start + s, start + s + 8 / G, ...

- A row's sums: lane l of the row's 32·G threads holds vectors l, l + 32·G,
  ... (4 f32 each) and adds x² and (dy·scale)·x over them by fmaf; the 32
  lane sums of a warp are reduced by xor shuffles (16, 8, 4, 2, 1), the G
  warp sums added in warp order. rstd = 1 / sqrt(Σx² / D + eps), dx =
  rstd·(dy·scale) − x·(rstd³·Σ(dy·scale)·x / D).
- dscale: each thread adds fmaf(dy·x, rstd, acc) over its slot's rows in
  order; the slots' sums are added in slot order (the block's partial);
  after the grid barrier lane l of the column's warp adds the partials of
  blocks l, l + 32, ... in order, and the 32 lane sums are reduced by xor
  shuffles.

The emulation runs those steps in numpy f32 (fmaf as the f64 sum rounded
once to f32; one f32 product is exact in f64) and is held to the card
tolerances of ``tests/test_torch_cuda.py::test_rmsnorm_bwd_kernel_matches_plain``
and ``chip_smoke.py``'s ``phase_rmsnorm_bwd``: dx within (D/2 + 8)·ε₃₂ and
dscale within (R/2 + D/2 + 8)·ε₃₂ of each output's largest entry, against
``jax.vjp`` of the reference's ``src/repro/models/layers.py::rms_norm`` at
small shapes (the tests' 7 rows, the cut-depth round's 128, a ragged band)
and against an f64 sum at the long shape [16384, 2048]. Inputs are the
card's (x ~ 3·N(0, 1), scale ~ 1 + 0.1·N(0, 1), dy ~ N(0, 1)), made with
numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import (BWD_WARPS, bwd_blocks,  # noqa: E402
                                                bwd_warps_a_row)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402

EPS32 = 2.0 ** -23
EPS = 1e-5
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op threads would only contend with XLA's pool in the
    same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((rows, d), dtype=F32)).astype(F32)
    scale = (1.0 + 0.1 * rng.standard_normal(d, dtype=F32)).astype(F32)
    dy = rng.standard_normal((rows, d), dtype=F32)
    return x, scale, dy


def fmaf(a, b, c):
    """f32 a·b + c rounded once (a·b of two f32 is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def xor_tree(v):
    """The xor-shuffle sum over the leading axis of 32 lanes (lane 0's)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ o]).astype(F32)
    return v[0]


def row_sums(a, b, d):
    """Σ a·b of each row [R, D] in the kernel's order: lane l of the row's
    32·G threads over its vectors l, l + 32·G, ... (4 values each) by fmaf,
    the warp's lanes by xor shuffles, the G warps in order."""
    g = bwd_warps_a_row(d)
    rows, nvec = a.shape[0], d // 4
    acc = np.zeros((32 * g, rows), dtype=F32)
    for i in range(-(-nvec // (32 * g))):
        for t in range(32 * g):
            j = t + 32 * g * i
            if j < nvec:
                for e in range(4):
                    acc[t] = fmaf(a[:, 4 * j + e], b[:, 4 * j + e], acc[t])
    warps = [xor_tree(acc[32 * w:32 * w + 32]) for w in range(g)]
    total = warps[0]
    for w in warps[1:]:
        total = (total + w).astype(F32)
    return total


def emulate_dscale(p, rstd, d):
    """dscale from p = dy·x [R, D] and rstd [R] (f32) in the kernel's order
    at this shape."""
    rows = p.shape[0]
    blocks = bwd_blocks(rows, d)
    slots = BWD_WARPS // bwd_warps_a_row(d)
    band = -(-rows // blocks)
    steps = -(-band // slots)
    # rows padded to blocks × band, laid out [block, step, slot]: a padded
    # row adds nothing (the kernel's slot stops at the band's end)
    pad = blocks * band - rows
    if pad:
        p = np.concatenate([p, np.zeros((pad, d), F32)])
        rstd = np.concatenate([rstd, np.zeros(pad, F32)])
    p, rstd = p.reshape(blocks, band, d), rstd.reshape(blocks, band)
    if steps * slots > band:
        p = np.concatenate([p, np.zeros((blocks, steps * slots - band, d), F32)], axis=1)
        rstd = np.concatenate([rstd, np.zeros((blocks, steps * slots - band), F32)], axis=1)
    p, rstd = p.reshape(blocks, steps, slots, d), rstd.reshape(blocks, steps, slots)
    acc = np.zeros((blocks, slots, d), F32)
    for k in range(steps):
        acc = fmaf(p[:, k], rstd[:, k, :, None], acc)
    part = acc[:, 0]
    for s in range(1, slots):
        part = (part + acc[:, s]).astype(F32)
    lanes = np.zeros((32, d), F32)
    for k in range(blocks):
        lanes[k % 32] = (lanes[k % 32] + part[k]).astype(F32)
    return xor_tree(lanes)


def emulate_rstd(x, d):
    ss = row_sums(x, x, d)
    return (F32(1.0) / np.sqrt((ss / F32(d) + F32(EPS)).astype(F32))).astype(F32)


def emulate(x, scale, dy):
    """(dx, dscale) as the kernel computes them at this shape (f32, D a
    multiple of 4: the 16-byte vector path)."""
    d = x.shape[1]
    rstd = emulate_rstd(x, d)
    g = (dy * scale).astype(F32)
    dot = row_sums(g, x, d)
    coef = (rstd * rstd * rstd * dot / F32(d)).astype(F32)
    dx = (rstd[:, None] * g - x * coef[:, None]).astype(F32)
    return dx, emulate_dscale((dy * x).astype(F32), rstd, d)


def jax_vjp(x, scale, dy):
    _, vjp = jax.vjp(lambda a, s: jax_rms_norm(a, s, EPS), jnp.asarray(x), jnp.asarray(scale))
    dx, ds = vjp(jnp.asarray(dy))
    return np.asarray(dx), np.asarray(ds)


def rel(got, want):
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) / float(
        np.abs(want).max())


@pytest.mark.parametrize("rows,d", [(7, 64), (128, 896), (33, 2048), (300, 4096), (1, 64)])
def test_kernel_order_matches_jax_vjp(rows, d):
    """The emulated kernel against ``jax.vjp`` of the reference's
    ``rms_norm`` (and the port's ``rmsnorm_bwd_ref``) within the card
    tolerances; (33, 2048) and (300, 4096) give G = 2 and 4 warps a row and
    bands that do not fill every slot."""
    x, scale, dy = make_inputs(rows, d, seed=rows + d)
    dx, ds = emulate(x, scale, dy)
    jdx, jds = jax_vjp(x, scale, dy)
    tdx, tds = (t.numpy() for t in rmsnorm_bwd_ref(*map(torch.from_numpy, (x, scale, dy)), EPS))
    for want_dx, want_ds in ((jdx, jds), (tdx, tds)):
        assert rel(dx, want_dx) <= (d / 2 + 8) * EPS32
        assert rel(ds, want_ds) <= (rows / 2 + d / 2 + 8) * EPS32


def test_kernel_order_at_the_long_shape_against_f64():
    """dscale at [16384, 2048] (256 blocks of 64 rows, 16 a slot; the
    partials over 8 blocks a lane) against the f64 sum of dy·x·rstd with
    rstd in f64, within (R/2 + D/2 + 8)·ε₃₂ of the largest entry."""
    rows, d = 16384, 2048
    assert bwd_blocks(rows, d) == 256 and bwd_warps_a_row(d) == 2
    x, scale, dy = make_inputs(rows, d, seed=5)
    ds = emulate_dscale((dy * x).astype(F32), emulate_rstd(x, d), d)
    want = np.zeros(d)
    for c in range(0, rows, 2048):   # f64 in chunks of rows
        x64 = x[c:c + 2048].astype(np.float64)
        rstd64 = 1.0 / np.sqrt(np.mean(x64 * x64, axis=1) + EPS)
        want += np.sum(dy[c:c + 2048].astype(np.float64) * x64 * rstd64[:, None], axis=0)
    err = rel(ds, want)
    assert err <= (rows / 2 + d / 2 + 8) * EPS32
    # the fixed tree keeps the error far inside the bound the tolerance allows
    assert err <= 1e-5
