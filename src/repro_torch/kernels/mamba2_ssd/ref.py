"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_scan_ref`` is the sequential recurrence (the JAX package's oracle,
extended to start from ``h0``); ``ssd_chunked`` the chunked-parallel form
that the JAX model runs (its XLA twin of the kernel); ``mamba2_ssd_ref``
the wrapper's plain version: ``ssd_chunked`` plus D·x, exactly as the JAX
model's ``mamba2_forward`` computes it.  fp32 state math throughout.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, B, C, A, D, h0=None):
    """x: (b,H,S,P); dt: (b,H,S); B,C: (b,S,N); A,D: (H,); h0: (b,H,P,N)
    fp32 or None (zero).

    h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t⊗B_t ;  y_t = C_t·h_t + D·x_t.
    Returns (y (b,H,S,P) in x's type, h_final (b,H,P,N) fp32).
    """
    b, H, s, P = x.shape
    N = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = torch.empty((b, H, s, P), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, :, t] * A[None, :])            # (b,H)
        upd = (dtf[:, :, t, None] * xf[:, :, t])[..., None] \
            * Bf[:, None, None, t, :]
        h = h * decay[..., None, None] + upd
        ys[:, :, t] = torch.einsum("bhpn,bn->bhp", h, Cf[:, t])
    y = ys + D[None, :, None, None] * xf
    return y.to(x.dtype), h


def ssd_chunked(xh, dt, A, B, C, chunk=64, h0=None):
    """Chunked-parallel SSD scan (the JAX model's ``ssd_chunked``).

    xh: (b, s, H, P) inputs; dt: (b, s, H) positive step sizes;
    A: (H,) negative decay rates; B, C: (b, s, N); h0: (b, H, P, N) or
    None.  Returns (y (b,s,H,P) in xh's type, h_final (b,H,P,N) fp32),
    without the D·x term.

    Within a chunk the recurrence is unrolled into two matmuls against
    decay-weighted masks; across chunks a short scan carries the state.
    """
    b, s, H, P = xh.shape
    N = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    L = chunk
    xc = xh.reshape(b, nc, L, H, P).float()
    dtc = dt.reshape(b, nc, L, H).float()
    Bc = B.reshape(b, nc, L, N).float()
    Cc = C.reshape(b, nc, L, N).float()

    dA = dtc * A                                             # (b,nc,L,H)
    seg = torch.cumsum(dA, dim=2)                            # Σ_{u<=t} dA_u
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # (b,nc,L,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))
    M = torch.where(causal[None, None, :, :, None], torch.exp(rel), 0.0)
    G = torch.einsum("bcln,bcmn->bclm", Cc, Bc)              # (b,nc,L,L)
    W = G[..., None] * M                                     # (b,nc,L,L,H)
    y_intra = torch.einsum("bclmh,bcmh,bcmhp->bclhp", W, dtc, xc)

    # chunk-final states: h_c = Σ_u e^{seg_L - seg_u} dt_u B_u ⊗ x_u
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)        # (b,nc,L,H)
    hc = torch.einsum("bclh,bclh,bcln,bclhp->bchpn",
                      decay_to_end, dtc, Bc, xc)             # per-chunk state
    chunk_decay = torch.exp(seg[:, :, -1, :])                # (b,nc,H)

    # inter-chunk scan (nc steps): h_prevs[c] is the state entering chunk c
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + hc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (b,nc,H,P,N)

    # contribution of the carried-in state to each position
    decay_from_start = torch.exp(seg)                        # (b,nc,L,H)
    y_inter = torch.einsum("bclh,bcln,bchpn->bclhp",
                           decay_from_start, Cc, h_prevs)
    y = (y_intra + y_inter).reshape(b, nc * L, H, P)
    if pad:
        y = y[:, :s]
    return y.to(xh.dtype), h


def mamba2_ssd_ref(x, dt, B, C, A, D, h0=None):
    """The wrapper's plain version, in the model layout: x (b,S,H,P), dt
    (b,S,H), B and C (b,S,N), A and D (H,), h0 (b,H,P,N) or None.

    ``ssd_chunked`` at the JAX model's chunk of 64, then D·x in y's type
    (``src/repro/models/ssm.py:171-172``).  Returns (y (b,S,H,P),
    h_final (b,H,P,N) fp32).
    """
    y, h_final = ssd_chunked(x, dt, A, B, C, chunk=64, h0=h0)
    y = y + D.to(y.dtype)[None, None, :, None] * x
    return y, h_final
