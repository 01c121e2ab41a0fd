"""Time K5 (the SSD chunked scan) at its serving paths' shapes in this
checkout and in another, in turns on one card.

    python3 tools/compare_k5.py OTHER_ROOT [--out build/k5_compare.json]

OTHER_ROOT is another checkout of this repository, for instance an earlier
commit unpacked with ``git archive <commit> | tar -x -C chip_check/parent``.
Each tree runs in a process of its own, with its own wrapper and its own
build of ``csrc/ssd_scan.cu``, in the order other, this, this, other, on the
same inputs (drawn on the card from fixed seeds); every tree is timed by
this checkout's ``chip_smoke.device_spread`` (the median, least and most
of at least 20 profiler samples, one launch each) and CUDA events
(``chip_smoke.time_ms``). A row holds the kernel's errors against its
plain version, as a share of
``chip_smoke.SSD_TOL``, and its times; every row is printed as a JSON line
and all are written to ``--out`` with a summary per shape: each tag's
device ms (the mean of its runs' medians) and the bound
(``chip_smoke.ssd_bound``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (b, s, h, p, g, n), the bf16 shapes of chip_smoke.py's K5 phases:
# mamba2-1.3b's and zamba2-1.2b's prefills (phases 13 and 20; phase 12's
# mamba2_bf16 and zamba2), then phase 12's ragged and grouped shapes
SHAPES = {
    "mamba2-1.3b": (8, 1024, 64, 64, 1, 128),
    "zamba2-1.2b": (8, 1024, 64, 64, 1, 64),
    "ragged": (8, 1000, 64, 64, 1, 128),
    "grouped": (8, 1024, 8, 64, 4, 128),
}
def run_tree(root, tag):
    """Every shape through ``root``'s own wrapper; prints one JSON line a
    row, prefixed with ``[k5-row]``."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    # this checkout's timing and bounds; the tree's modules are imported
    # already, so chip_smoke's own path entry does not replace them
    sys.path.insert(0, ROOT)
    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("compare_k5: no CUDA card")
    build.build("ssd_scan")
    tol = chip_smoke.SSD_TOL["bfloat16"]
    for i, (name, shape) in enumerate(SHAPES.items()):
        args = chip_smoke.ssd_operands(torch, *shape, "bfloat16", seed=200 + i)
        call = lambda: ops.ssd_scan(*args, chunk=128, return_state=True)
        y, state = call()
        torch.cuda.synchronize()
        want_y, want_state = ssd_reference(*args, chunk=128)
        spread = chip_smoke.device_spread(torch, call, "ssd_scan_")
        row = {"tree": tag, "shape": name,
               "y_tol_ratio": chip_smoke.allclose_ratio(torch, y, want_y, tol),
               "state_tol_ratio": chip_smoke.allclose_ratio(
                   torch, state, want_state, tol),
               "ms": chip_smoke.time_ms(torch, call, samples=10, inner=10),
               "device_ms": spread and spread["median"],
               "device_ms_min": spread and spread["min"],
               "device_ms_max": spread and spread["max"],
               "device_samples": spread and spread["samples"]}
        print("[k5-row] " + json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "k5_compare.json"))
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:
        run_tree(args.tree, args.tag)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    other = os.path.abspath(args.other)
    runs = [("other", other), ("this", ROOT)]
    runs += runs[::-1]
    rows = []
    for tag, root in runs:
        cmd = [sys.executable, os.path.abspath(__file__), other, "--tree",
               root, "--tag", tag]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                              check=False)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise SystemExit(f"compare_k5: the {tag} run ({root}) failed "
                             f"with exit {proc.returncode}")
        rows += [json.loads(line.split(" ", 1)[1])
                 for line in proc.stdout.splitlines()
                 if line.startswith("[k5-row] ")]
    sys.path.insert(0, ROOT)
    import chip_smoke
    summary = {}
    for name, shape in SHAPES.items():
        summary[name] = {"bound_ms": chip_smoke.ssd_bound(*shape,
                                                          "bfloat16")[0]}
        for tag in dict.fromkeys(r["tree"] for r in rows):
            got = [r["device_ms"] for r in rows
                   if r["shape"] == name and r["tree"] == tag]
            summary[name][f"device_ms_{tag}"] = sum(got) / len(got)
    print("[k5-summary] " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "other": other, "rows": rows,
                   "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
