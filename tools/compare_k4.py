"""Time K4 (flash attention) at its serving paths' shapes in this checkout
and in another, in turns on one card.

    python3 tools/compare_k4.py OTHER_ROOT [--out build/k4_compare.json]

OTHER_ROOT is another checkout of this repository, for instance an earlier
commit unpacked with ``git archive <commit> | tar -x -C chip_check/parent``.
Each tree runs in a process of its own, with its own ``chip_smoke.fa_row``
and its own build of ``csrc/flash_attention.cu``, in the order other, this,
this, other, on the same inputs (drawn on the card from fixed seeds). A row
holds the kernel's max abs error against its plain version and its times:
CUDA events ("ms"), the profiler's device time ("device_ms"), the plain
version, scaled_dot_product_attention ("library_ms", a yardstick the port
never calls) and the bound (``chip_smoke.fa_bound``). Every row is printed
as a JSON line and all are written to ``--out``, with a summary per shape:
the device ms of each tree (the mean of its two runs) and their ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (B, S, Hq, Hkv, D, window), the bf16 shapes K4 is launched at on
# the serving paths of chip_smoke.py (phases 11, 20-22 and 24), then the
# other bf16 shapes of its FA_SHAPES
SHAPES = {
    "smollm-135m": (8, 1024, 9, 3, 64, None),
    "seamless-m4t-large-v2": (8, 1024, 16, 16, 64, None),
    "zamba2-1.2b": (8, 1024, 32, 32, 64, None),
    "deepseek-7b": (8, 1024, 32, 32, 128, None),
    "chatglm3-6b": (8, 1024, 32, 2, 128, None),
    "granite-34b": (8, 1024, 48, 1, 128, None),
    "qwen2-vl-72b": (8, 1024, 64, 8, 128, None),
    "mixtral-8x22b": (2, 6144, 48, 8, 128, 4096),
    "ragged": (8, 1000, 9, 3, 64, None),
    "window": (8, 2048, 9, 3, 64, 256),
    "d128": (2, 2048, 32, 8, 128, None),
}


def run_tree(root, tag):
    """Every shape through ``root``'s own fa_row; prints one JSON line a
    row, prefixed with ``[k4-row]``."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("compare_k4: no CUDA card")
    build.build("flash_attention")
    for i, (name, (B, S, Hq, Hkv, D, window)) in enumerate(SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn((B, S, h, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        row = chip_smoke.fa_row(torch, name, q, k, v, window)
        print("[k4-row] " + json.dumps({"tree": tag, "shape": name, **row},
                                       default=str), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "k4_compare.json"))
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
    rows = []
    for tag, root in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               other, "--tree", root, "--tag", tag],
                              stdout=subprocess.PIPE, text=True, check=False)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise SystemExit(f"compare_k4: the {tag} tree ({root}) failed "
                             f"with exit {proc.returncode}")
        rows += [json.loads(line.split(" ", 1)[1])
                 for line in proc.stdout.splitlines()
                 if line.startswith("[k4-row] ")]
    summary = {}
    for name in SHAPES:
        mean = {tag: sum(r["device_ms"] for r in rows if r["shape"] == name
                         and r["tree"] == tag) / 2
                for tag in ("this", "other")}
        summary[name] = {"device_ms_this": mean["this"],
                         "device_ms_other": mean["other"],
                         "other_over_this": mean["other"] / mean["this"]}
    print("[k4-summary] " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "other": other, "rows": rows,
                   "summary": summary}, f, indent=1, default=str)


if __name__ == "__main__":
    main()
