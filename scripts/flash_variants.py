#!/usr/bin/env python3
"""The tensor-core flash kernels on one card: device time by kernel, and the
backward against variants of its own source, in turns.

    python3 scripts/flash_variants.py

At Gemma-2B's [8, 1,024, 8 on 1, 256], Zamba2-7B's [8, 1,024, 32, 112] and
DeepSeek-V2's MLA [2, 1,024, 128, 192/128] (bf16, causal):

  * device time by kernel (torch.profiler, the mean of 5 calls): the
    serving forward (`flash_tc_kernel`) and the backward's passes
    (`prep_kernel`, `dkdv_kernel`, `dkdv_sum_kernel`, `dq_kernel`) — the
    kernels alone, without the host's share that a CUDA-event timing of a
    Python call includes;
  * the backward (`csrc/flash_attention_bwd_tc.cu`) against three edited
    copies of its source, compiled with the port's flags into
    ``build/flash_variants/`` and swapped in through `_build.loaded_from`:
    ``parts2`` (p and ds in two bf16 parts, not three), ``no_split`` (the
    dK/dV pass never splits the query heads) and ``tc_sum`` (the
    accumulating products summed in the tensor cores' accumulators over
    the whole pass, not added to f32 on the CUDA cores tile by tile).  For
    each:
    each gradient's largest error as a share of its largest magnitude and
    the share of its elements that differ from the plain version's, the
    same bits on two launches, and the time (CUDA events, median of 10) in
    the order this, variants, variants reversed, this.

Prints one JSON object per shape and section, then the card's name and
power limit.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = (("gemma-2b", 8, 1024, 8, 1, 256, 256),
          ("zamba2-7b", 8, 1024, 32, 32, 112, 112),
          ("deepseek-v2 mla", 2, 1024, 128, 128, 192, 128))
# (name, ((text in the source, its replacement), ...))
VARIANTS = (
    ("parts2", (("constexpr int TERMS = 3;", "constexpr int TERMS = 2;"),)),
    ("no_split", (("  while (g % (2 * s) == 0",
                   "  while (false && g % (2 * s) == 0"),)),
    ("tc_sum", (("wgmma_rs_n64(t, f[p][kk], db, kk + p > 0);",
                 "wgmma_rs_n64(acc[nb], f[p][kk], db, 1);"),
                ("wgmma_rs_n48(t, f[p][kk], db, kk + p > 0);",
                 "wgmma_rs_n48(acc[nb], f[p][kk], db, 1);"),
                ("if (full || i < 24) acc[nb][i] += t[i];",
                 "if (full || i < 24) (void)t[i];"))),
)


def variant_libs() -> dict:
    """{name: library path} of each variant of the backward's source."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    out_dir = ROOT / "build" / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(v):
        name, edits = v
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"flash_variants: {name}: {old!r} is not "
                                 f"in the source")
            text = text.replace(old, new)
        f = out_dir / f"{name}.cu"
        f.write_text(text)
        _build.compile_source(f, f.with_suffix(".so"))
        return name, f.with_suffix(".so")

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(build, VARIANTS))


def by_kernel(fn, reps: int = 5) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / reps)
    return out


def main() -> None:
    import contextlib

    import torch

    from chip_smoke import event_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a GPU")
    dev = torch.device("cuda")
    libs = variant_libs()
    gen = torch.Generator(device=dev).manual_seed(21)
    for label, B, T, H, KV, d, dv in SHAPES:
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = r(B, T, H, d), r(B, T, KV, d), r(B, T, KV, dv), \
            r(B, T, H, dv)
        o, m, l = fa.flash_attention_stats_reference(q, k, v)
        bwd = lambda: fa.flash_attention_backward(q, k, v, o, m, l, do)
        print(json.dumps({"shape": label, "forward_ms": by_kernel(
            lambda: fa.flash_attention(q, k, v)), "backward_ms": by_kernel(
            bwd)}), flush=True)
        want = fa.flash_attention_backward_reference(q, k, v, o, m, l, do)
        names = ["this", *libs]
        res, times = {}, {n: [] for n in names}
        for n in names + names[::-1]:
            with (contextlib.nullcontext() if n == "this" else
                  _build.loaded_from("flash_attention_bwd_tc", libs[n])):
                if n not in res:
                    g1, g2 = bwd(), bwd()
                    torch.cuda.synchronize()
                    res[n] = {
                        "rel": [float((a.float() - b.float()).abs().max())
                                / float(b.float().abs().max())
                                for a, b in zip(g1, want)],
                        "elements_off": [float((a != b).float().mean())
                                         for a, b in zip(g1, want)],
                        "same_bits": all(torch.equal(a, b)
                                         for a, b in zip(g1, g2))}
                bwd()
                times[n].append(event_ms(bwd, 10))
        print(json.dumps({"shape": label, "variants": {
            n: res[n] | {"ms": times[n]} for n in names}}), flush=True)
        del q, k, v, do, o, m, l, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
