"""State-space / linear-attention blocks on the chunked-SSD core
(`repro_torch.kernels.ops.ssd`): Mamba2 and RWKV6 (Finch).

Port of `repro.models.ssm`:

    h_t = d_t ⊙ h_{t−1} + b_t ⊗ x_t,     y_t = c_t · h_t

  * Mamba2: d_t = exp(−Δt·exp(A_log)) (a scalar per head, broadcast over
    the state dim N), b_t = Δt·B_t, c_t = C_t, a D-skip and a SiLU-gated
    output.
  * RWKV6: d_t = exp(−exp(w_t)) per channel (a data-dependent decay from a
    low-rank "lora" on w), b_t = k_t, c_t = r_t, the current token through
    the bonus u (``include_current=False``), token-shift mixing and a
    channel-mix block.

Prefill runs the whole sequence through the `ssd` kernel on a card; decode
carries the O(1) state through `ssd_decode_step` (no kernel, as in the
reference).

The reference's dtype promotions are kept: Mamba2's Δt and decay and
RWKV6's decay are f32, the projections come out in the parameter dtype, so
at bf16 the kernel receives f32 d (and Mamba2's f32 b), bf16 c and x, and y
comes back in x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (constrain, merge_heads,
                                              split_heads)
from repro_torch.kernels import ops
from repro_torch.models.layers import normal, param_dtype


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, stack: int = 0
                ) -> dict:
    d = cfg.d_model
    di = 2 * d                      # expansion factor 2
    hs, n = cfg.ssm_heads, cfg.ssm_state
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": normal(gen, (*pre, d, 2 * di), dt, d ** -0.5),
        "bcdt_proj": normal(gen, (*pre, d, 2 * n + hs), dt, d ** -0.5),
        "conv_w": normal(gen, (*pre, 4, di), dt, 0.5),
        "a_log": torch.log(torch.linspace(1.0, 8.0, hs, **f32)).expand(
            *pre, hs).contiguous(),
        "dt_bias": torch.full((*pre, hs), -4.0, **f32),
        "d_skip": torch.ones((*pre, hs), **f32),
        "out_proj": normal(gen, (*pre, di, d), dt, di ** -0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0)), with
    no switch to the identity (`F.softplus` returns x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _mamba_pre(p: dict, x, cfg: ArchConfig, conv_state=None):
    """Shared projections: (xs [B,T,H,P], z, d, b, c, conv_tail); d, b, c
    are [B, T, H, N] broadcast views."""
    B, T, D = x.shape
    di = 2 * D
    hs, n = cfg.ssm_heads, cfg.ssm_state
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    # depthwise causal conv of width 4, the four shifted products summed in
    # the reference's order (with the carried tail for decode)
    if conv_state is not None:
        xpad = torch.cat([conv_state, xi], dim=1)
    else:
        xpad = F.pad(xi, (0, 0, 3, 0))
    w = p["conv_w"]
    xc = xpad[:, 0:T] * w[0][None, None]
    for i in range(1, 4):
        xc = xc + xpad[:, i:i + T] * w[i][None, None]
    xc = F.silu(xc)
    bcdt = x @ p["bcdt_proj"]
    b_in = bcdt[..., :n]
    c_in = bcdt[..., n:2 * n]
    dt_raw = bcdt[..., 2 * n:].float()
    delta = softplus(dt_raw + p["dt_bias"][None, None])          # [B,T,H]
    decay = torch.exp(-delta * torch.exp(p["a_log"])[None, None])
    hspec = ("dp", None, "tp", None)
    xs = constrain(split_heads(xc, (B, T, hs, di // hs)), hspec)
    d_full = constrain(decay[..., None].expand(B, T, hs, n), hspec)
    b_full = constrain(delta[..., None]
                       * b_in[:, :, None, :].expand(B, T, hs, n), hspec)
    c_full = constrain(c_in[:, :, None, :].expand(B, T, hs, n), hspec)
    # the tail is copied out so a cached tail does not hold all of xpad
    return xs, z, d_full, b_full, c_full, xpad[:, -3:].clone()


def mamba2_forward(p: dict, x, cfg: ArchConfig, chunk: int = 64):
    """Full-sequence Mamba2 block.  Returns (y, (h_final, conv_tail))."""
    B, T, D = x.shape
    xs, z, d, b, c, tail = _mamba_pre(p, x, cfg)
    y, hT = ops.ssd(d.contiguous(), b.contiguous(), xs.contiguous(),
                    c.contiguous(), chunk=min(chunk, T),
                    include_current=True)
    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * xs
    y = merge_heads(y) * F.silu(z)
    return y @ p["out_proj"], (hT, tail)


def mamba2_decode(p: dict, x, cfg: ArchConfig, h, conv_state):
    """One-token decode.  h: [B,H,N,P] f32; conv_state: [B,3,di].
    Returns (y, h_next, conv_tail)."""
    xs, z, d, b, c, tail = _mamba_pre(p, x, cfg, conv_state)
    y, h_next = ops.ssd_decode_step(d[:, 0], b[:, 0], xs[:, 0], c[:, 0],
                                    h=h, include_current=True)
    y = y + p["d_skip"][None, :, None].to(y.dtype) * xs[:, 0]
    y = merge_heads(y)[:, None] * F.silu(z)
    return y @ p["out_proj"], h_next, tail



# ================================================================== RWKV6 ==
_RWKV_LORA = 64


def rwkv6_init(gen: torch.Generator, cfg: ArchConfig, stack: int = 0
               ) -> dict:
    """Time-mix (r, k, v, g, o; decay lora w0 + tanh(x·w1)·w2; bonus u) and
    channel-mix (ck, cv) parameters of one RWKV6 layer."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    lora = _RWKV_LORA
    dev = gen.device
    sq = lambda name: (name, normal(gen, (*pre, d, d), dt, d ** -0.5))
    p = dict([("mix", torch.full((*pre, 5, d), 0.5, dtype=dt, device=dev)),
              sq("wr"), sq("wk"), sq("wv"), sq("wg"), sq("wo")])
    p["w0"] = torch.full((*pre, d), -4.0, dtype=torch.float32, device=dev)
    p["w1"] = normal(gen, (*pre, d, lora), dt, d ** -0.5)
    p["w2"] = normal(gen, (*pre, lora, d), dt, lora ** -0.5)
    p["u"] = normal(gen, (*pre, d // hd, hd), torch.float32, 0.1)
    p["cmix"] = torch.full((*pre, d), 0.5, dtype=dt, device=dev)
    p["ck"] = normal(gen, (*pre, d, cfg.d_ff), dt, d ** -0.5)
    p["cv"] = normal(gen, (*pre, cfg.d_ff, d), dt, cfg.d_ff ** -0.5)
    return p


def _shift(x, prev):
    """Token shift: x_{t−1} with the carried boundary.  prev: [B, 1, D]."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _time_mix_in(p: dict, x, xs):
    """r, k, v (in x's dtype), the f32 decay and the SiLU gate from the
    token and its shifted predecessor, each [B, T, D]."""
    mix = p["mix"]

    def mixed(i):
        return x * mix[i][None, None] + xs * (1 - mix[i][None, None])

    w_raw = (p["w0"][None, None].float()
             + torch.tanh(mixed(3).float() @ p["w1"].float())
             @ p["w2"].float())
    return (mixed(0) @ p["wr"], mixed(1) @ p["wk"], mixed(2) @ p["wv"],
            torch.exp(-torch.exp(w_raw)), F.silu(mixed(4) @ p["wg"]))


def rwkv6_time_mix(p: dict, x, cfg: ArchConfig, prev_x=None, h0=None,
                   chunk: int = 64):
    """RWKV6 time-mix (the linear-attention half) over a sequence.
    Returns (y, (hT [B, nh, hd, hd] f32, x_last [B, 1, D]))."""
    B, T, D = x.shape
    hd = cfg.rwkv_head_dim
    nh = D // hd
    prev = x.new_zeros((B, 1, D)) if prev_x is None else prev_x
    r, k, v, decay, g = _time_mix_in(p, x, _shift(x, prev))
    heads = lambda t: constrain(
        split_heads(t, (B, T, nh, hd)).contiguous(), ("dp", None, "tp", None))
    y, hT = ops.ssd(heads(decay), heads(k), heads(v), heads(r), u=p["u"],
                    h0=h0, chunk=min(chunk, T), include_current=False)
    y = merge_heads(y) * g
    return y @ p["wo"], (hT, x[:, -1:])


def rwkv6_time_mix_decode(p: dict, x, cfg: ArchConfig, h, prev_x):
    """One-token time-mix.  h: [B, nh, hd, hd] f32; prev_x: [B, 1, D].
    Returns (y, h_next, x)."""
    B, _, D = x.shape
    hd = cfg.rwkv_head_dim
    nh = D // hd
    r, k, v, decay, g = _time_mix_in(p, x, prev_x)
    heads = lambda t: split_heads(t[:, 0], (B, nh, hd))
    y, h_next = ops.ssd_decode_step(heads(decay), heads(k), heads(v),
                                    heads(r), u=p["u"], h=h,
                                    include_current=False)
    return (merge_heads(y)[:, None] * g) @ p["wo"], h_next, x


def rwkv6_channel_mix(p: dict, x, prev_x=None):
    """RWKV channel-mix (the MLP half) with token shift.  Returns (y,
    x_last)."""
    B, T, D = x.shape
    prev = x.new_zeros((B, 1, D)) if prev_x is None else prev_x
    xs = _shift(x, prev)
    xm = x * p["cmix"][None, None] + xs * (1 - p["cmix"][None, None])
    return torch.square(F.relu(xm @ p["ck"])) @ p["cv"], x[:, -1:]
