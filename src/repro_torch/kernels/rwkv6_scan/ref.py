"""RWKV6 ("Finch") WKV recurrence: the exact oracle and the chunked closed
form, in torch.

Per head: state S in R^{dk x dv};  w_t in (0,1)^{dk} is the data-dependent
decay, u in R^{dk} the first-token bonus:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``rwkv6_scan_ref`` is the exact sequential oracle.  ``rwkv6_chunked`` is
the block-parallel form used for prefill and the plain version of K10: all
pairwise decay factors are exp(L_{t-1,d} - L_{s,d}) with L = cumsum(log w),
whose exponent is <= 0 wherever the causal mask admits it, so the form
cannot overflow.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Exact recurrence.

    r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk);
    s0: (B, H, dk, dv) or None.
    Returns o: (B, H, T, dv), sT: (B, H, dk, dv).  fp32 internally.
    """
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w = (x.to(F32) for x in (r, k, v, w))
    u = u.to(F32)
    S = (torch.zeros((B, H, dk, dv), dtype=F32, device=r.device) if s0 is None
         else s0.to(F32))
    outs = []
    for t in range(T):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,dk,dv)
        wkv = S + u[None, :, :, None] * kv                   # bonus on current
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, wkv))
        S = wt[..., :, None] * S + kv
    return torch.stack(outs, dim=2), S


def chunk_body(r, k, v, lw, u, s0):
    """One chunk for a batch of heads: the arithmetic K10 runs.

    r, k: (N, C, dk); v: (N, C, dv); lw = log(w): (N, C, dk); u: (N, dk);
    s0: (N, dk, dv).  Returns (o (N, C, dv), s1 (N, dk, dv)).
    """
    C = r.shape[1]
    Lc = torch.cumsum(lw, dim=1)                  # L_t, t = 1..C      (N, C, dk)
    Lprev = Lc - lw                               # L_{t-1}            (N, C, dk)

    q = r * torch.exp(Lprev)                      # decayed receptance
    inter = q @ s0                                # (N, C, dv) cross-chunk

    # intra-chunk pairwise: A[t,s] = sum_d r_td k_sd exp(L_{t-1,d} - L_{s,d})
    expo = Lprev[:, :, None, :] - Lc[:, None, :, :]        # (N, C, C, dk)
    expo = torch.clamp(expo, max=0.0)                      # masked region safety
    A = torch.einsum("ntd,ntsd,nsd->nts", r, torch.exp(expo), k)
    mask = torch.tril(torch.ones((C, C), dtype=A.dtype, device=A.device), diagonal=-1)
    intra = (A * mask) @ v                                 # (N, C, dv)

    bonus = torch.sum(r * u[:, None, :] * k, dim=2, keepdim=True) * v

    o = inter + intra + bonus

    # state propagation: S' = exp(L_C) . S0 + sum_s exp(L_C - L_s) k_s v_s^T
    decay_all = torch.exp(Lc[:, -1])                       # (N, dk)
    kd = k * torch.exp(Lc[:, -1:, :] - Lc)                 # (N, C, dk)
    s1 = decay_all[:, :, None] * s0 + kd.transpose(1, 2) @ v
    return o, s1


def chunk_body_factored(r, k, v, lw, u, s0, *, sub: int = 16):
    """chunk_body as K10's output and state passes compute it (csrc/rwkv6.cu),
    in torch on a batch of heads: the same arguments and returns.

    Lprev_t is L_{t-1} (L_{-1} = 0).  The chunk is cut into sub-chunks of
    ``sub`` steps.  A's diagonal blocks keep the pairwise form with the
    reference's clamp.  Left of them, for t in sub-chunk I and s in an
    earlier one, the decay is factored about b = I * sub - 1 (the last step
    of sub-chunk I - 1):
    exp(Lprev_t - L_s) = exp(Lprev_t - L_b) exp(L_b - L_s), each exponent
    clamped at 0, so A's rows of I left of the diagonal are one product of
    r exp(Lprev - L_b) and (k exp(L_b - L))^T.  Both factors are at most 1
    wherever w <= 1.  The kernel works in base 2 (log2, exp2), the same
    function; here natural units, as chunk_body takes them.
    """
    N, C, dk = r.shape
    Lc = torch.cumsum(lw, dim=1)
    Lprev = torch.cat([torch.zeros_like(Lc[:, :1]), Lc[:, :-1]], dim=1)
    inter = (r * torch.exp(Lprev)) @ s0
    A = torch.zeros((N, C, C), dtype=r.dtype, device=r.device)
    for i0 in range(0, C, sub):
        i1 = min(i0 + sub, C)
        expo = torch.clamp(Lprev[:, i0:i1, None, :] - Lc[:, None, i0:i1, :], max=0.0)
        diag = torch.einsum("ntd,ntsd,nsd->nts", r[:, i0:i1], torch.exp(expo), k[:, i0:i1])
        A[:, i0:i1, i0:i1] = torch.tril(diag, diagonal=-1)
        if i0:
            Lb = Lc[:, i0 - 1:i0]
            rh = r[:, i0:i1] * torch.exp(torch.clamp(Lprev[:, i0:i1] - Lb, max=0.0))
            kh = k[:, :i0] * torch.exp(torch.clamp(Lb - Lc[:, :i0], max=0.0))
            A[:, i0:i1, :i0] = rh @ kh.transpose(1, 2)
    bonus = torch.sum(r * u[:, None, :] * k, dim=2, keepdim=True) * v
    o = inter + A @ v + bonus
    kd = k * torch.exp(Lc[:, -1:, :] - Lc)
    s1 = torch.exp(Lc[:, -1])[:, :, None] * s0 + kd.transpose(1, 2) @ v
    return o, s1


def rwkv6_chunked(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """Block-parallel closed form (the torch engine, K10's plain version).
    Same signature and returns as rwkv6_scan_ref; T must be a multiple of
    ``chunk``."""
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    if T % chunk:
        raise ValueError(f"chunk={chunk} must divide T={T}")
    N = B * H
    r, k, v = (x.to(F32).reshape(N, T, -1) for x in (r, k, v))
    # clamp: w can underflow to 0 (extreme decay), and log(0) = -inf makes
    # (-inf) - (-inf) = NaN in the pairwise form
    lw = torch.log(torch.clamp(w.to(F32), min=1e-26)).reshape(N, T, dk)
    uh = u.to(F32).expand(B, H, dk).reshape(N, dk)
    S = (torch.zeros((N, dk, dv), dtype=F32, device=r.device) if s0 is None
         else s0.to(F32).reshape(N, dk, dv))
    outs = []
    for c in range(0, T, chunk):
        sl = slice(c, c + chunk)
        o, S = chunk_body(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], uh, S)
        outs.append(o)
    o = torch.cat(outs, dim=1).reshape(B, H, T, dv)
    return o, S.reshape(B, H, dk, dv)


def rwkv6_decode_ref(r1, k1, v1, w1, u, s):
    """Single decode step.  r1,k1,w1: (B,H,dk); v1: (B,H,dv); s: (B,H,dk,dv).
    Returns (o (B,H,dv), s')."""
    r1, k1, v1, w1 = (x.to(F32) for x in (r1, k1, v1, w1))
    kv = k1[..., :, None] * v1[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r1, s + u.to(F32)[None, :, :, None] * kv)
    s = w1[..., :, None] * s + kv
    return o, s
