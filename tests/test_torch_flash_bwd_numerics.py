"""The precision routes and schedules of the two backward kernels, emulated
on the CPU in plain torch, against JAX.

``flash_attention_bwd`` (``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cu``) runs its five products (S = QKᵀ, dP = dO Vᵀ,
dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K) on Hopper's tensor cores:

- f32 inputs, 3×TF32: every operand split into hi = rna_tf32(x) and lo =
  rna_tf32(x − hi), each product a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in f32;
- bf16 inputs: S and dP in one bf16 pass (exact products, f32 sums); P and
  dS, the A operand of the three accumulating products, split into hi =
  bf16(x) and lo = bf16(x − hi), two passes each.

The tests here show that both routes hold the card tolerances of
``tests/test_torch_cuda.py::test_flash_attention_bwd_kernel_matches_plain``
and ``chip_smoke.py``'s ``phase_flash_bwd`` — max|Δ| ≤ 1e-5·max|ref| for
each of dq, dk, dv in f32 and ≤ 2⁻⁷·max|ref| in bf16 — against ``jax.vjp``
of ``repro.kernels.flash_attention.ref.attention_ref``, and that one TF32
pass does not. One unsplit bf16 P and dS holds 2⁻⁷ too at these inputs
(its largest error 5.4e-3 against the split's 4.7e-3: the bf16 inputs, o
and outputs dominate both), so it is not pinned here; the kernel keeps the
split for gradients that nearly cancel. The emulation rounds every
operand as the kernel does (TF32 by bit masking, as ``cvt.rna``); only the
order of the f32 sums differs. The forward's o and lse come through the
same route, as the kernel's training build gives them. Inputs are the card
tests' (q, k, v, dO ~ N(0, 1)), made with numpy from a seed, at their
shapes: the training shape (causal, G = 7), d = 128 (G = 6) and a window
of 64 with G = 7.

``slstm_bwd`` (``src/repro_torch/kernels/slstm/csrc/slstm_bwd.cu``) is
emulated as it schedules the reverse scan: blocks of cw channels of a head,
each forming dh′ of its channels from its rows of R against the head's
dpre of the step after, exchanged through the output; the thread (js, q)
partial sums over the column groups js, js + KS, ... (fmaf in column
order) and their sum in js order. The emulation is held against ``slstm_bwd_ref`` and
``jax.vjp`` of ``repro.models.xlstm._slstm_core`` under
``chip_smoke.py``'s drift rule (4× the plain version's f32-vs-f64 distance
plus 1e-5 of the largest entry), at d = 64 and d = 8, with S = 1, B = 9
(two passes) and a d whose channels do not divide into cw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref  # noqa: E402

FLASH_CASES = {   # (BHkv, G, S, d, causal, window): the card tests' shapes
    "train_g7": (16, 7, 128, 64, True, None),
    "d128_g6": (2, 6, 130, 128, True, None),
    "window64_g7": (2, 7, 300, 64, True, 64),
}
F32_TOL = 1e-5        # of each gradient's largest entry
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ flash attention

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` (``test_torch_flash_numerics.py``'s)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def mm_bf16_split(a, b):
    """a in two bf16 passes (hi, lo) against b (bf16 values), f32 sums."""
    hi = a.to(torch.bfloat16).float()
    return (a - hi).to(torch.bfloat16).float() @ b + hi @ b


ROUTES = {   # (the two score products, the three accumulating products)
    "3xtf32": (mm_3xtf32, mm_3xtf32),
    "1xtf32": (mm_1xtf32, mm_1xtf32),
    "bf16_split": (torch.matmul, mm_bf16_split),
}


def allowed_mask(sq, t, causal, window):
    qp, kp = torch.arange(sq)[:, None], torch.arange(t)[None, :]
    ok = torch.ones((sq, t), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def emulate_bwd(q, k, v, do, g, causal, window, route):
    """q, do [BHq, S, d] and k, v [BHkv, T, d] -> (dq, dk, dv) in q's dtype,
    the forward's o and lse and all five products through ``route``."""
    score_mm, acc_mm = ROUTES[route]
    d = q.shape[-1]
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kk, vv = (x.float().repeat_interleave(g, dim=0) for x in (k, v))
    ok = allowed_mask(q.shape[1], k.shape[1], causal, window)
    s = torch.where(ok, score_mm(qf, kk.transpose(1, 2)) * scale, -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    o = acc_mm(p, vv).to(q.dtype).float()          # the forward's output
    dvec = torch.sum(dof * o, dim=-1, keepdim=True)
    dp = score_mm(dof, vv.transpose(1, 2))
    ds = p * (dp - dvec)
    dq = acc_mm(ds, kk) * scale
    per_kv = lambda x: x.reshape(k.shape[0], g, *x.shape[1:]).sum(dim=1)
    dk = per_kv(acc_mm(ds.transpose(1, 2), qf)) * scale
    dv = per_kv(acc_mm(p.transpose(1, 2), dof))
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_inputs(bhkv, g, s, d, dtype, seed=2):
    rng = np.random.default_rng(seed)
    shapes = ((bhkv * g, s, d), (bhkv, s, d), (bhkv, s, d), (bhkv * g, s, d))
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(getattr(torch, dtype))
            for sh in shapes]


def flash_reference(q, k, v, do, g, causal, window):
    """``jax.vjp`` of JAX's ``attention_ref`` in f32 on the inputs' values."""
    bhq, s, d = q.shape
    as_j = lambda x, h: jnp.asarray(x.float().numpy()).reshape(1, h, s, d)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal, window=window),
                     as_j(q, bhq), as_j(k, k.shape[0]), as_j(v, k.shape[0]))
    grads = vjp(as_j(do, bhq))
    return [torch.from_numpy(np.array(x)).reshape(y.shape) for x, y in zip(grads, (q, k, v), strict=True)]


def rel_errs(got, want):
    return [float((a.float() - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want, strict=True)]


@pytest.fixture(scope="module")
def flash_cases():
    """Each case's inputs and JAX reference, per dtype, made once."""
    out = {}
    for name, (bhkv, g, s, d, causal, window) in FLASH_CASES.items():
        for dtype in ("float32", "bfloat16"):
            x = flash_inputs(bhkv, g, s, d, dtype)
            out[name, dtype] = (x, flash_reference(*x, g, causal, window))
    return out


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("route,dtype,tol,holds", [
    ("3xtf32", "float32", F32_TOL, True), ("1xtf32", "float32", F32_TOL, False),
    ("bf16_split", "bfloat16", BF16_TOL, True)])
def test_flash_bwd_route_against_jax_vjp(flash_cases, case, route, dtype, tol, holds):
    """3×TF32 and split bf16 hold the card tolerance on dq, dk and dv; one
    TF32 pass breaks it on at least one."""
    _, g, _, _, causal, window = FLASH_CASES[case]
    x, want = flash_cases[case, dtype]
    errs = rel_errs(emulate_bwd(*x, g, causal, window, route), want)
    assert (max(errs) <= tol) == holds, (route, errs)


# ----------------------------------------------------------------------- sLSTM

def fmaf(a, b, c):
    """f32 a·b + c with one rounding (the product exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_slstm_bwd(d_hs, d_hT, d_cT, d_nT, res, r, cw):
    """``slstm_bwd.cu``'s reverse scan at ``cw`` channels a block: dh′ of a
    block's channels from the head's dpre of step t + 1 (the exchange) and
    its rows of R, thread (js, q)'s partials over the column groups js,
    js + KS, ... (4 columns each, j = g·d + e) in fmaf column order, summed
    in js order; the cell as the plain version writes it. Returns (dpre,
    dh0, dc0, dn0)."""
    _, cprev, nprev, i, f, tz, so, c, n = res
    s, bsz, heads, d = d_hs.shape
    ks = min(256 // (cw // 4), d)
    dpre = torch.empty((s, bsz, 4, heads, d))

    def exchange(t):
        """dh′ [B, H, d] from dpre[t], block by block, in the kernel's order."""
        out = torch.empty((bsz, heads, d))
        x = dpre[t].reshape(bsz, 4, heads, d).permute(0, 2, 1, 3).reshape(bsz, heads, 4 * d)
        for h in range(heads):
            for e0 in range(0, d, cw):
                ch = min(cw, d - e0)
                rows = r[h, e0:e0 + ch].reshape(ch, 4 * d)        # [k, j = g·d + e]
                part = torch.zeros((ks, bsz, ch))   # thread js's partials
                for i in range(-(-d // ks)):          # its column groups jg = js + KS·i
                    jg = torch.arange(ks) + ks * i
                    for jj in range(4):
                        j = (4 * jg + jj).clamp(max=4 * d - 1)
                        upd = fmaf(x[:, h, j].T[:, :, None], rows[:, j].T[:, None, :], part)
                        part = torch.where((jg < d)[:, None, None], upd, part)
                acc = torch.zeros((bsz, ch))
                for js in range(ks):
                    acc = acc + part[js]
                out[:, h, e0:e0 + ch] = acc
        return out

    dh_n, dc_n, dn_n = d_hT, d_cT, d_nT
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            dh_n = exchange(t + 1)
        dh = d_hs[t] + dh_n
        nn = torch.clamp_min(n[t], 1e-6)
        do_pre = dh * (c[t] / nn) * so[t] * (1 - so[t])
        dc = dh * so[t] / nn + dc_n
        dn = -dh * so[t] * c[t] / (nn * nn) + dn_n
        dz_pre = dc * i[t] * (1 - tz[t] * tz[t])
        di_pre = (dc * tz[t] + dn) * i[t]
        df_pre = (dc * cprev[t] + dn * nprev[t]) * f[t]
        dpre[t] = torch.stack([di_pre, df_pre, dz_pre, do_pre], dim=1)
        dc_n, dn_n = dc * f[t], dn * f[t]
    return dpre, exchange(0), dc_n, dn_n


SLSTM_CASES = {   # (S, B, H, d, cw): cw the kernel's choice at these shapes on 132
    # SMs (4), but for ragged_cw, whose 16-channel blocks leave the last 8
    "d64": (6, 3, 2, 64, 4),
    "d8_h1": (5, 2, 1, 8, 4),
    "s1": (1, 3, 2, 64, 4),
    "b9_two_passes": (3, 9, 1, 16, 4),
    "ragged_cw": (3, 2, 1, 24, 16),
}


def slstm_inputs(s, b, h, d, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    ins = (f(s, b, 4, h, d), f(h, d, 4, d) / np.sqrt(d).astype(np.float32), 0.1 * f(4, h, d),
           0.5 * f(b, h, d), 0.5 * f(b, h, d), np.abs(f(b, h, d)) + 0.5, f(b, h, d))
    cts = (f(s, b, h, d), f(b, h, d), f(b, h, d), f(b, h, d))
    return ins, cts


@pytest.mark.parametrize("case", list(SLSTM_CASES))
def test_slstm_bwd_schedule_against_plain_and_jax_vjp(case):
    """The kernel's schedule (blocks of cw channels, the dpre exchange, the
    order of its partial sums) against ``slstm_bwd_ref`` on the same
    residuals and against ``jax.vjp`` of ``_slstm_core``: dgx (= dpre), dh0,
    dc0, dn0 each within 4× the plain version's f32-vs-f64 distance plus
    1e-5 of its largest entry."""
    s, b, h, d, cw = SLSTM_CASES[case]
    ins, cts = slstm_inputs(s, b, h, d)
    t = [torch.from_numpy(x) for x in ins]
    hs, _, saved = slstm_ref(*t, save=True)
    res = (torch.cat([t[3][None], hs[:-1]]), torch.cat([t[4][None], saved[0][:-1]]),
           torch.cat([t[5][None], saved[1][:-1]]), *saved[2:], saved[0], saved[1])
    ct = [torch.from_numpy(x) for x in cts]
    got = emulate_slstm_bwd(*ct, res, t[1], cw)
    plain = slstm_bwd_ref(*ct, res, t[1])
    exact = slstm_bwd_ref(*(x.double() for x in ct), tuple(x.double() for x in res),
                          t[1].double())
    _, vjp = jax.vjp(jxlstm._slstm_core, *(jnp.asarray(x) for x in ins))
    jgrads = vjp((*(jnp.asarray(x) for x in cts), jnp.zeros_like(jnp.asarray(cts[1]))))
    jax_out = [np.array(jgrads[i]) for i in (0, 3, 4, 5)]
    for name, e, p, x, j in zip(("dpre", "dh0", "dc0", "dn0"), got, (plain[0], *plain[3:6]),
                                (exact[0], *exact[3:6]), jax_out, strict=True):
        drift = float((p.double() - x).abs().max())
        tol = 4 * drift + 1e-5 * float(x.abs().max())
        assert float((e.double() - p.double()).abs().max()) <= tol, (name, "plain")
        assert float((e.double() - torch.from_numpy(j).double()).abs().max()) <= tol, \
            (name, "jax")
