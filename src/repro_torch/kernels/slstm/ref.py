"""Plain PyTorch version of the sLSTM time-scan kernel: the xLSTM sLSTM
cell (``repro.models.xlstm._slstm_cell``) in a loop over time."""
from __future__ import annotations

import torch


def slstm_ref(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """gx [S, B, 4, H, d] (gates i, f, z, o); r [H, d, 4, d]; b [4, H, d];
    states [B, H, d]. Returns (hs [S, B, H, d] in gx's dtype, (h, c, n, m)
    in f32, f64 for an f64 gx).

    The recurrent product rounds h to r's dtype and accumulates in f32, as
    the model's cell does (``einsum(h.astype(r.dtype), r,
    preferred_element_type=f32)``); everything after it is f32, with the
    xLSTM m-stabilizer. An f64 gx makes all of it f64 (h still rounded to
    r's dtype): the accurate version a kernel's tolerance is measured
    against.
    """
    wt = torch.float64 if gx.dtype == torch.float64 else torch.float32
    rf = r.to(wt)
    h, c, n, m = (t.to(wt) for t in (h0, c0, n0, m0))
    hs = torch.empty(gx.shape[:2] + gx.shape[3:], dtype=gx.dtype, device=gx.device)
    for t in range(gx.shape[0]):
        rec = torch.einsum("bhd,hdge->bghe", h.to(r.dtype).to(wt), rf)
        pre = gx[t].to(wt) + rec + b.to(wt)
        it, ft, zt, ot = pre.unbind(1)
        m_new = torch.maximum(ft + m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(ft + m - m_new)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs[t] = h
    return hs, (h, c, n, m)
