"""Public entries to the port's kernels, routed as `repro.kernels.ops` routes.

  * `attention` — decode calls (one query) and calls with explicit key
    positions go to the exact naive `ref.attention_ref`; full sequences go
    to `flash_attention`.
  * `ssd` — the chunked recurrence, `ssm_scan.ssd`.
  * `ssd_decode_step` — the O(1) one-token update, `ref.ssd_decode_step`
    (no kernel: the reference has none either); on a mesh on each rank's
    batch and head shard.
  * `thermal_conv` — the Γ-coupled pole-bank trace.

Each kernel wrapper runs its hand-written CUDA kernel for CUDA tensors and
its plain PyTorch version for CPU tensors: the tensors' device decides,
nothing else (there is no environment switch).  A failed build or launch
raises; it never falls back to the plain version.

On a mesh (DTensor inputs) `attention` (both routes) and `ssd` run the
same functions on each rank's local batch and head shard
(`sharding.local_attention`, `sharding.local_ssd`; ``kv_positions`` must
then be a plain tensor, the same on every rank); the kernel modules
themselves take plain tensors only.
"""
from repro_torch.distributed import sharding
from repro_torch.kernels import ref, ssm_scan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.thermal_conv import thermal_conv

__all__ = ["attention", "ssd", "ssd_decode_step", "thermal_conv"]


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              kv_positions=None, scale=None):
    """Multi-head attention (GQA/MQA aware).  q: [B, Tq, H, d]; k, v:
    [B, Tk, KV, d].  See the module docstring for the routing."""
    if q.shape[1] == 1 or kv_positions is not None:
        naive = lambda a, b, c: ref.attention_ref(
            a, b, c, causal=causal, window=window, q_offset=q_offset,
            kv_positions=kv_positions, scale=scale)
        if sharding.is_distributed(q):
            return sharding.local_attention(naive, q, k, v)
        return naive(q, k, v)
    if sharding.is_distributed(q):
        return sharding.local_attention(
            lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                            window=window, q_offset=q_offset,
                                            scale=scale), q, k, v)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale)


def ssd(d, b, x, c, *, u=None, h0=None, chunk=64, include_current=True):
    """The chunked recurrence (`ssm_scan.ssd`, same arguments)."""
    if sharding.is_distributed(x):
        return sharding.local_ssd(
            lambda *t: ssm_scan.ssd(*t[:4], u=t[4], h0=t[5], chunk=chunk,
                                    include_current=include_current),
            d, b, x, c, u, h0)
    return ssm_scan.ssd(d, b, x, c, u=u, h0=h0, chunk=chunk,
                        include_current=include_current)


def ssd_decode_step(d, b, x, c, *, u=None, h=None, include_current=True):
    """One token of the recurrence (`ref.ssd_decode_step`, same
    arguments); on a mesh on each rank's batch and head shard
    (`sharding.local_ssd_decode`)."""
    step = lambda d_, b_, x_, c_, u_, h_: ref.ssd_decode_step(
        d_, b_, x_, c_, u=u_, h=h_, include_current=include_current)
    if sharding.is_distributed(x):
        return sharding.local_ssd_decode(step, d, b, x, c, u, h)
    return step(d, b, x, c, u, h)
