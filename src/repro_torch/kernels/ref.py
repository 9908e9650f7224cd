"""Plain PyTorch oracles of the model stack's attention and recurrence.

Port of the parts of `repro.kernels.ref` the serving models need besides
the two kernels' own plain versions (those sit beside their kernels, in
`flash_attention.py` and `ssm_scan.py`):

  * `attention_ref` — naive O(Tq·Tk) attention with GQA/MQA, causal and
    sliding-window masks, ``q_offset`` and explicit key positions
    (``kv_positions``, −1 marks an unfilled cache slot).  The decode path.
  * `ssd_decode_step` — one token of the linear recurrence
    h_t = d_t ⊙ h_{t−1} + b_t ⊗ x_t, y_t = c_t · h_t.  The decode path.
  * `linear_scan_ref` — the O(T) sequential recurrence, the tests' oracle of
    oracles for the chunked form.

All of it computes in f32 and casts back to the input's dtype, as the
reference does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def keep_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
              window: int) -> torch.Tensor:
    """[Tq, Tk] boolean keep-mask from absolute positions."""
    m = (kpos[None, :] >= 0).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_positions=None, scale=None):
    """Naive attention oracle.

    q: [B, Tq, H, d]; k, v: [B, Tk, KV, d(v)] with H % KV == 0.
    q_offset: absolute position of q[0] (decode: the cache length).
    kv_positions: [Tk] absolute key positions; default arange(Tk).
    """
    B, Tq, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = H // KV
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qpos = q_offset + torch.arange(Tq, device=dev)
    kpos = (torch.arange(Tk, device=dev) if kv_positions is None
            else kv_positions)
    qf = q.reshape(B, Tq, KV, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    s = torch.where(keep_mask(qpos, kpos, causal, window)[None, None, None],
                    s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Tq, H, dv).to(q.dtype)


def linear_scan_ref(d, b, h0=None):
    """Sequential oracle: h_t = d_t ⊙ h_{t−1} + b_t over axis 1 (time).

    d, b: [B, T, ...] broadcast-compatible.  Returns (h_all [B, T, ...],
    h_T).
    """
    d = torch.broadcast_to(d, torch.broadcast_shapes(d.shape, b.shape))
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    hs = []
    for t in range(b.shape[1]):
        h = d[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


def ssd_decode_step(d, b, x, c, *, u=None, h=None, include_current=True):
    """One-token recurrence update.

    d, b, c: [B, H, N]; x: [B, H, P]; h: [B, H, N, P] f32.
    Returns (y [B, H, P] in x's dtype, h_next f32).  With
    ``include_current`` (Mamba2) y reads the updated state; without it
    (RWKV6) the decayed previous state plus the ``u`` bonus, matching the
    chunked form's weighting.
    """
    out_dtype = x.dtype
    d, b, c, x = (t.float() for t in (d, b, c, x))
    if h is None:
        h = torch.zeros((*d.shape, x.shape[-1]), dtype=torch.float32,
                        device=d.device)
    h_next = d[..., None] * h + b[..., None] * x[..., None, :]
    if include_current:
        y = torch.einsum("bhn,bhnp->bhp", c, h_next)
    else:
        y = torch.einsum("bhn,bhnp->bhp", c, d[..., None] * h)
        if u is not None:
            y = y + torch.einsum("bhn,hn,bhn->bh", c, u.float(),
                                 b)[..., None] * x
    return y.to(out_dtype), h_next
