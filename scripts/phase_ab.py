#!/usr/bin/env python3
"""Time the `chip_smoke.py` phases that a change to the serving, mesh or
example paths touches — G, H, K, O, and Q where the checkout has it — in
one checkout, after building its kernels, on one card.

    python3 scripts/phase_ab.py CHECKOUT

CHECKOUT is the root of a checkout of the repository (``.`` for this
one); its own `chip_smoke.py` and kernels run, so two revisions are
compared by unpacking the other with ``git archive REV | tar -x -C DIR``
into a directory that ``.gitignore`` lists and alternating them in one
session on one card (parent, change, parent, change): a host's speed
drifts between runs, so each change run is read against the parent run
just before it.  Prints, as its last line, ``AB <name> {phase: seconds,
"H+K+O+Q": their sum}`` (host clock; G's only feeds H and K).  Needs a GPU.
"""
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

assert Path(cs.__file__).resolve().parent == root
with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
    list(pool.map(_build.build, cs.KERNELS))
dev = torch.device("cuda")
sec = {}


def run(name, fn, *a):
    t = time.perf_counter()
    out = fn(*a)
    sec[name] = round(time.perf_counter() - t, 1)
    return out


fa_entry, ssd_entry = run("G", cs.phase_g, dev)
run("H", cs.phase_h, dev, fa_entry, ssd_entry)
run("K", cs.phase_k, dev, fa_entry, ssd_entry)
run("O", cs.phase_o, dev, None)
if hasattr(cs, "phase_q"):
    run("Q", cs.phase_q, dev)
sec["H+K+O+Q"] = round(sum(v for k, v in sec.items() if k != "G"), 1)
print("AB " + root.name + " " + json.dumps(sec))
