"""What K4's wgmma route waits on, measured on one card: the kernel with one
part taken out at a time, timed at the serving paths' shapes beside the
kernel as it is.

    python3 tools/ablate_k4.py [--out build/k4_ablate.json]

Each variant is a text edit of ``src/repro_torch/csrc/flash_attention.cu``,
built with the port's nvcc flags into ``build/ablate/`` and called through
the port's wrapper in place of its library. The ablations (``no_exp``: P
from the exponent's argument, no ex2; ``no_s``: no S = Q K^T product;
``no_pv``: no O += P V product; ``loads_only``: none of the three) compute
wrong results by design and are timed only; the kernel as it is (``as_is``,
first and last) and the design alternatives (``three_stages``: a ring of 3
kv stages; ``q_slowest`` and ``q_fastest``: one grid order at every shape)
are checked against the plain version first. Times are CUDA events
(``chip_smoke.time_ms``), with the bound beside.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.dirname(__file__)]

NO_EXP = ("pack_bf16(ex2(fmaf(s[4 * j + 2 * r], sl, -mlog[r])),\n"
          "                          ex2(fmaf(s[4 * j + 2 * r + 1], sl, "
          "-mlog[r])))",
          "pack_bf16(fmaf(s[4 * j + 2 * r], sl, -mlog[r]),\n"
          "                          fmaf(s[4 * j + 2 * r + 1], sl, "
          "-mlog[r]))")
# P still feeds the accumulator behind a test the compiler cannot decide,
# so that the softmax is not removed with the product
NO_PV = ("          if constexpr (D == 64) {\n"
         "            wgmma_rs_n64(acc, pf[kk], dv);\n"
         "          } else if constexpr (D == 128) {\n"
         "            wgmma_rs_n128(acc, pf[kk], dv);\n"
         "          } else {  // two halves of 128 columns, two panels apart\n"
         "            wgmma_rs_n128(acc, pf[kk], dv);\n"
         "            wgmma_rs_n128(acc + 64, pf[kk],\n"
         "                          sw128_desc(v_s + 2 * kKvPanel + kk * 16 * 128,\n"
         "                                     kKvPanel, 1024));\n"
         "          }",
         "          if (dv == 1)\n"
         "            acc[0] += __uint_as_float(pf[kk][0] ^ pf[kk][1] ^ "
         "pf[kk][2] ^ pf[kk][3]);")
NO_S = ("            wgmma_ss_n64(s, dq, dk, ks > 0);\n"
        "          else\n"
        "            wgmma_ss_n128(s, dq, dk, ks > 0);",
        "            { if (ks < 0) wgmma_ss_n64(s, dq, dk, ks > 0); }\n"
        "          else\n"
        "            { if (ks < 0) wgmma_ss_n128(s, dq, dk, ks > 0); }")
Q_FAST = "  const int q_fast = 4ll * B * Skv * Hkv * d > kKvL2Bytes;"
VARIANTS = {
    "as_is": [],
    "three_stages": [("constexpr int kStages = 2;",
                      "constexpr int kStages = 3;")],
    "q_slowest": [(Q_FAST, "  const int q_fast = 0;")],
    "q_fastest": [(Q_FAST, "  const int q_fast = 1;")],
    "no_exp": [NO_EXP],
    "no_s": [NO_S],
    "no_pv": [NO_PV],
    "loads_only": [NO_EXP, NO_S, NO_PV],
}
ABLATIONS = {"no_exp", "no_s", "no_pv", "loads_only"}


def build_variant(name, edits):
    """The path of the variant's library, built from the edited source."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"ablate_k4: {name}: the source no longer "
                             f"holds {old!r} once")
        src = src.replace(old, new)
    out_dir = os.path.join(ROOT, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"ablate_k4: {name} does not build:\n"
                         f"{proc.stdout}{proc.stderr}")
    return lib


def use_library(lib):
    """Route the port's wrapper through ``lib``'s C entry."""
    import ctypes
    from repro_torch.kernels.flash_attention import kernel
    fn = ctypes.CDLL(lib).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kernel._fn = fn


def main(argv=None):
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import chip_smoke
    from compare_k4 import SHAPES
    from repro_torch.kernels.flash_attention import ops
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "k4_ablate.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k4: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                           VARIANTS.values())))
    inputs = {}
    for i, (name, (B, S, Hq, Hkv, D, window)) in enumerate(SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        inputs[name] = [torch.randn((B, S, h, D), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for h in (Hq, Hkv, Hkv)]
    rows = []
    for variant in [*VARIANTS, "as_is"]:
        use_library(libs[variant])
        for name, (q, k, v) in inputs.items():
            window = SHAPES[name][5]
            call = lambda: ops.flash_attention(q, k, v, window=window)
            row = {"variant": variant, "shape": name}
            if variant not in ABLATIONS:
                got = call()
                err = float((got.float() - chip_smoke.fa_plain(
                    torch, q, k, v, window).float()).abs().max())
                if not err <= chip_smoke.FA_TOL["bfloat16"]:
                    raise SystemExit(f"ablate_k4: {variant} at {name}: max "
                                     f"abs err {err}")
                row["max_abs_err"] = err
            row["ms"] = chip_smoke.time_ms(torch, call, samples=10,
                                           inner=10)
            row["bound_ms"] = chip_smoke.fa_bound(*SHAPES[name],
                                                  "bfloat16")[0]
            rows.append(row)
            print("[k4-ablate] " + json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
