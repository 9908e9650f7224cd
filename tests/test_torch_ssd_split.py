"""PyTorch port: the split-precision products of the `ssd` backward kernel,
restated in PyTorch on the CPU and held to the f32 plain backward.

``csrc/ssd_bwd.cu`` takes every chunk product on the tensor cores in TF32
(mma.sync m16n8k8).  To keep f32-grade results it splits each f32 operand
v into two TF32 parts, hi = rna(v) (round to nearest, ties away from zero,
to 10 fraction bits: cvt.rna.tf32.f32's rounding) and lo = v − hi (exact)
with its 13 low bits cleared, and forms a product as lo·hi, then hi·lo,
then hi·hi, each an 8-deep step added into one f32 accumulator (lo·lo is
dropped); an operand that is exact in TF32 (a bf16 value) has lo = 0.
`split_mm` restates that: the TF32 products are exact in f32, and each
step's eight are summed in order (the tensor core's own order inside a
step is its own).  On it `split_backward` builds the
backward's chunk formulas with the kernel's operand orders — Sᵀ = b̂·ĉᵀ and
dSᵀ = x·dyᵀ formed directly, dx = Sᵀ·dy + b̃·dh and dĉ = dS·b̂ + dy·hᵀ
each in one accumulator, b̃ = b̂·e^{Lc}, the walk's ĉᵀ·dy — and every leaf
is held to `ssd_backward_reference` (itself held to ``jax.vjp`` of the
reference in tests/test_torch_ssd_backward.py) within Phase L's 1e-4 of
its largest magnitude, at Zamba2-like and RWKV6-like inputs, with f32 and
with bf16-valued x and dy.  The same formulas on one TF32 part a product
are printed beside, not asserted: how far the split's absence lands.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssm_scan as sm

LEAF_TOL = 1e-4
NAMES = ("dd", "db", "dx", "dc", "du", "dh0")
# (B, T, H, N, P, decay low, include_current, u)
REGIMES = {
    "zamba2-like": (2, 256, 2, 64, 64, 0.55, True, False),
    "rwkv6-like": (2, 256, 2, 64, 64, 0.8, False, True),
}


def tf32(v):
    """v rounded to TF32 (10 fraction bits), to nearest with ties away from
    zero: the magnitude's bits plus half a unit, the low 13 bits cleared."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v):
    """(hi, lo) as the kernel forms them: hi = tf32(v), lo = v − hi (exact
    in f32) cut to TF32 (the low 13 bits cleared)."""
    hi = tf32(v)
    lo = (v - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def split_mm(a, b, acc=None, parts=3):
    """acc + a·b (a [..., M, K], b [..., K, N] f32, K a multiple of 8) as
    the kernel forms it: per 8-deep step, the parts lo·hi, hi·lo, hi·hi in
    turn, each step's eight exact products summed in order and added to
    the f32 accumulator.  parts=1: hi·hi alone, one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if parts == 3 else ((ah, bh),)
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None
           else acc.clone())
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            s = x[..., :, k0, None] * y[..., None, k0, :]
            for k in range(k0 + 1, k0 + 8):
                s = s + x[..., :, k, None] * y[..., None, k, :]
            out = out + s
    return out


def split_backward(d, b, x, c, u, hs, dy, dhT, chunk, inc, mm):
    """`ssd_backward_reference`'s chunk formulas, every chunk product
    taken by ``mm`` in the kernel's operand order."""
    B, T, H, N = d.shape
    P = x.shape[-1]
    nc = T // chunk
    f32 = torch.float32
    rs = lambda t, w: t.reshape(B, nc, chunk, H, w).to(f32).permute(
        0, 1, 3, 2, 4)                                  # [B, nc, H, C, w]
    tr = lambda t: t.transpose(-1, -2)
    dr, br, xr, cr, dyr = rs(d, N), rs(b, N), rs(x, P), rs(c, N), rs(dy, P)
    hsr = hs.to(f32)                                    # [B, nc, H, N, P]
    L = torch.cumsum(torch.log(torch.clamp(dr, min=1e-20)), dim=3)
    Lc = L[..., -1, :]                                  # [B, nc, H, N]
    elc = torch.exp(Lc)
    eL, einv = torch.exp(L), torch.exp(-L)
    ch, bh = cr * eL, br * einv
    bt = bh * elc[..., None, :]                         # b̃ = b̂·e^{Lc}
    t_i = torch.arange(chunk)
    keep_ts = ((t_i[None, :] <= t_i[:, None]) if inc
               else (t_i[None, :] < t_i[:, None]))      # [t, s]
    keep_st = keep_ts.T

    # the walk (pass A): dh leaving each chunk
    dh = torch.zeros((B, H, N, P)) if dhT is None else dhT.to(f32)
    dhs = [None] * nc
    for g in reversed(range(nc)):
        dhs[g] = dh
        dh = elc[:, g, ..., None] * dh + mm(tr(ch[:, g]), dyr[:, g])
    DH = torch.stack(dhs, 1)

    ST = torch.where(keep_st, mm(bh, tr(ch)), 0.0)      # [s, t]
    dx = mm(bt, DH, acc=mm(ST, dyr))
    dST = torch.where(keep_st, mm(xr, tr(dyr)), 0.0)    # [s, t]
    db_hat = mm(dST, ch)
    dS = torch.where(keep_ts, mm(dyr, tr(xr)), 0.0)     # [t, s]
    dc_hat = mm(dyr, tr(hsr), acc=mm(dS, bh))
    db_tld = mm(xr, tr(DH))

    dLc = (hsr * DH).sum(-1) * elc + (db_tld * bt).sum(3)
    dL = dc_hat * ch - db_hat * bh - db_tld * bt
    dc = dc_hat * eL
    db = db_hat * einv + db_tld * torch.exp(Lc[..., None, :] - L)
    du = None
    if u is not None:
        uf = u.to(f32)[None, None, :, None, :]
        su = (cr * uf * br).sum(-1)                     # [B, nc, H, C]
        dsu = (dyr * xr).sum(-1)
        dx = dx + su[..., None] * dyr
        dc = dc + dsu[..., None] * uf * br
        db = db + dsu[..., None] * uf * cr
        du = (dsu[..., None] * cr * br).sum((0, 1, 3))
    dlogd = torch.flip(torch.cumsum(torch.flip(dL, (3,)), 3), (3,)) \
        + dLc[..., None, :]
    dd = torch.where(dr > 1e-20, dlogd / dr, 0.0)
    back = lambda t, like: t.permute(0, 1, 3, 2, 4).reshape(like.shape)
    return back(dd, d), back(db, b), back(dx, x), back(dc, c), du, dh


def _inputs(regime, bf16_xy, seed=23):
    B, T, H, N, P, lo, inc, use_u = REGIMES[regime]
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    d = torch.from_numpy(rng.uniform(lo, 0.999, (B, T, H, N))
                         .astype(np.float32))
    b, c = 0.2 * f(B, T, H, N), 0.2 * f(B, T, H, N)
    x, dy = f(B, T, H, P), f(B, T, H, P)
    if bf16_xy:     # the training runs' bf16 x and dy, widened
        x, dy = x.bfloat16().float(), dy.bfloat16().float()
    u = 0.1 * f(H, N) if use_u else None
    dhT = f(B, H, N, P)
    hs = sm.ssd_reference(d, b, x, c, u=u, chunk=64, include_current=inc,
                          states=True)[2]
    return (d, b, x, c, u, hs, dy, dhT), inc


def _gaps(got, want):
    return {n: float((a - w).abs().max() / w.abs().max())
            for n, a, w in zip(NAMES, got, want) if w is not None}


def test_split_parts():
    """hi and lo are TF32 (13 low bits clear), v − hi − lo stays below 2⁻²¹
    of |v|, and a bf16 value splits into itself and zero."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = split(v)
    for part in (hi, lo):
        assert bool((part.view(torch.int32) & 0x1FFF == 0).all())
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert bool((rest < 2.0 ** -21 * v.double().abs()).all())
    w = v.bfloat16().float()
    hw, lw = split(w)
    assert torch.equal(hw, w) and bool((lw == 0).all())


@pytest.mark.parametrize("bf16_xy", [False, True], ids=["f32", "bf16 x, dy"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_split_backward_holds_the_f32_gate(regime, bf16_xy):
    args, inc = _inputs(regime, bf16_xy)
    want = sm.ssd_backward_reference(*args[:5], None, *args[5:], chunk=64,
                                     include_current=inc)
    got = split_backward(*args, 64, inc, split_mm)
    gaps = _gaps(got, want)
    one = _gaps(split_backward(*args, 64, inc,
                               lambda a, b, acc=None: split_mm(a, b, acc,
                                                               parts=1)),
                want)
    print(f"\n{regime}, {'bf16' if bf16_xy else 'f32'} x and dy: each "
          f"leaf's largest gap to the f32 plain backward as a share of its "
          f"largest magnitude — 3×TF32 "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + "; one TF32 product "
          + ", ".join(f"{k} {v:.2e}" for k, v in one.items()))
    for name, gap in gaps.items():
        assert gap <= LEAF_TOL, (regime, bf16_xy, name, gap)
