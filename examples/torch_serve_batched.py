"""Batched serving with thermal admission control, on the PyTorch port.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The port's counterpart of examples/serve_batched.py: the reference's three
scenarios through `repro_torch.launch.serve.main`, with its argv plus
``--device`` (CUDA unless ``--device cpu`` is given).  Every wave loop runs
on the fleet engine (a fleet of one package by default):

  (a) V24 on mixtral-8x7b, reduced: the PDU gate throttles admission when
      the predicted junction temperature approaches the limit — P99 stays
      smooth (paper §8.1); on a card each prefill's attention is one
      launch of the hand-written flash kernel a layer, the routed MoE
      beside it;
  (b) long-context decode on an SSM (rwkv6-1.6b, reduced): each prefill's
      time mix is one launch of the `ssd` kernel a layer, with RWKV6's
      bonus `u`;
  (c) the (a) loop batched across a 4-package fleet on the broadcast
      backend with per-package workload jitter — the per-wave fleet
      telemetry line is the aggregate a control-plane flush reports.

`main` returns each scenario's result from `serve.main`.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device
from repro_torch.launch import serve

SCENARIOS = {
    "mixtral": ["--arch", "mixtral-8x7b", "--reduced", "--batch", "8",
                "--prompt-len", "48", "--gen", "16", "--waves", "3"],
    "rwkv6": ["--arch", "rwkv6-1.6b", "--reduced", "--batch", "4",
              "--prompt-len", "64", "--gen", "16", "--waves", "2"],
    "fleet": ["--arch", "mixtral-8x7b", "--reduced", "--batch", "8",
              "--prompt-len", "48", "--gen", "16", "--waves", "2",
              "--fleet", "4", "--fleet-backend", "broadcast"],
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    args = ap.parse_args(argv)
    dev = ["--device", str(resolve_device(args.device))]

    print("== V24 thermal-admission serving (mixtral-8x7b, reduced) ==")
    out = serve.main(SCENARIOS["mixtral"] + dev)
    print(f"summary: p50 {out['p50'] * 1e3:.2f} ms  "
          f"p99 {out['p99'] * 1e3:.2f} ms  admissions {out['admitted']}")

    print("\n== long-context decode on an SSM (rwkv6, reduced) ==")
    out2 = serve.main(SCENARIOS["rwkv6"] + dev)
    print(f"summary: p50 {out2['p50'] * 1e3:.2f} ms  "
          f"p99 {out2['p99'] * 1e3:.2f} ms")

    print("\n== fleet of 4 packages, same serving loop (broadcast backend) ==")
    out3 = serve.main(SCENARIOS["fleet"] + dev)
    last = out3["fleet"][-1]
    print(f"summary: p50 {out3['p50'] * 1e3:.2f} ms  "
          f"p99 {out3['p99'] * 1e3:.2f} ms"
          f"  fleet p99 temp {last['temp_p99_c']:.1f} C"
          f"  f_mean {last['freq_mean']:.3f}")
    return {"mixtral": out, "rwkv6": out2, "fleet": out3}


if __name__ == "__main__":
    main()
