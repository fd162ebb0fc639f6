"""Plain PyTorch version of the sLSTM time-scan kernel: the xLSTM sLSTM
cell (``repro.models.xlstm._slstm_cell``) in a loop over time."""
from __future__ import annotations

import torch


def slstm_ref(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor, save: bool = False):
    """gx [S, B, 4, H, d] (gates i, f, z, o); r [H, d, 4, d]; b [4, H, d];
    states [B, H, d]. Returns (hs [S, B, H, d] in gx's dtype, (h, c, n, m)
    in f32, f64 for an f64 gx).

    The recurrent product rounds h to r's dtype and accumulates in f32, as
    the model's cell does (``einsum(h.astype(r.dtype), r,
    preferred_element_type=f32)``); everything after it is f32, with the
    xLSTM m-stabilizer. An f64 gx makes all of it f64 (h still rounded to
    r's dtype): the accurate version a kernel's tolerance is measured
    against.

    ``save=True`` also returns, third, what the backward reads (the stores
    of the kernel's training build): saved [6, S, B, H, d] = c, n, i, f,
    tanh(z), sigmoid(o) of every step, in the working type.
    """
    wt = torch.float64 if gx.dtype == torch.float64 else torch.float32
    rf = r.to(wt)
    h, c, n, m = (t.to(wt) for t in (h0, c0, n0, m0))
    hs = torch.empty(gx.shape[:2] + gx.shape[3:], dtype=gx.dtype, device=gx.device)
    saved = (torch.empty((6,) + hs.shape, dtype=wt, device=gx.device) if save
             else None)
    for t in range(gx.shape[0]):
        rec = torch.einsum("bhd,hdge->bghe", h.to(r.dtype).to(wt), rf)
        pre = gx[t].to(wt) + rec + b.to(wt)
        it, ft, zt, ot = pre.unbind(1)
        m_new = torch.maximum(ft + m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(ft + m - m_new)
        tz, so = torch.tanh(zt), torch.sigmoid(ot)
        c = f * c + i * tz
        n = f * n + i
        h = so * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs[t] = h
        if save:
            for slot, v in zip(saved, (c, n, i, f, tz, so)):
                slot[t] = v
    if save:
        return hs, (h, c, n, m), saved
    return hs, (h, c, n, m)


def slstm_bwd_ref(d_hs, d_hT, d_cT, d_nT, saved, r):
    """A direct port of the model's hand-written BPTT
    (``src/repro/models/xlstm.py::_slstm_core_bwd``): ``saved`` the
    reference's per-step residuals (h_prev, c_prev, n_prev, i, f, tanh z,
    sigmoid o, c, n), each [S, B, H, d], the cotangents of hs and of the
    final (h, c, n) (m's is ignored: the stabilizer is a constant). Returns
    (dgx [S, B, 4, H, d], dr [H, d, 4, d], db [4, H, d], dh0, dc0, dn0,
    dm0 = 0). dpre is cast to r's dtype for the recurrent product, as the
    reference does."""
    hprev, cprev, nprev, i, f, tz, so, c, n = saved
    dh_next, dc_next, dn_next = d_hT, d_cT, d_nT
    dpre = torch.empty((d_hs.shape[0], d_hs.shape[1], 4) + d_hs.shape[2:],
                       dtype=d_hs.dtype, device=d_hs.device)
    for t in range(d_hs.shape[0] - 1, -1, -1):
        dh = d_hs[t] + dh_next
        nn = torch.clamp_min(n[t], 1e-6)
        do_pre = dh * (c[t] / nn) * so[t] * (1 - so[t])
        dc = dh * so[t] / nn + dc_next
        dn = -dh * so[t] * c[t] / (nn * nn) + dn_next
        dz_pre = dc * i[t] * (1 - tz[t] * tz[t])
        di_pre = (dc * tz[t] + dn) * i[t]
        df_pre = (dc * cprev[t] + dn * nprev[t]) * f[t]
        dpre[t] = torch.stack([di_pre, df_pre, dz_pre, do_pre], dim=1)
        wt = d_hs.dtype
        dh_next = torch.einsum("bghe,hdge->bhd", dpre[t].to(r.dtype).to(wt), r.to(wt))
        dc_next, dn_next = dc * f[t], dn * f[t]
    dr = torch.einsum("sbhd,sbghe->hdge", hprev, dpre)
    db = torch.sum(dpre, dim=(0, 1))
    return dpre, dr, db, dh_next, dc_next, dn_next, torch.zeros_like(dh_next)
