"""What K5's wgmma route waits on, measured on one card: the kernel with one
part taken out at a time, timed at the serving paths' shapes beside the
kernel as it is.

    python3 tools/ablate_k5.py [--out build/k5_ablate.json]

Each variant is a text edit of ``src/repro_torch/csrc/ssd_scan.cu``, built
with the port's nvcc flags into ``build/ablate_k5/`` and called through
the port's wrapper in place of its library. The ablations put an issue
behind a test the compiler cannot decide (``if (a.N < 0)``), so that what
feeds it stays: ``no_s`` (no S = C B^T), ``no_cht`` (no y += C h^T),
``no_state`` (no state update), ``no_mx`` (no masked product with x),
``no_products`` (none of the four), ``no_ystore`` (no TMA store of y) and
``no_dt_load`` (dt a constant, not loaded). They compute wrong results by
design and are timed only; the kernel as it is (``as_is``, first and
last) and the design alternative ``three_chunk_stages`` (a ring of 3
chunk stages) are checked against the plain version at
``chip_smoke.SSD_TOL`` first. Times are the median, least and most of at
least 20 profiler samples (``chip_smoke.device_spread``) and CUDA events
(``chip_smoke.time_ms``), with the bound beside; each variant's ptxas
registers, spills (after the function they belong to) and wgmma
warnings are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.dirname(__file__)]

NEVER = "if (a.N < 0) "


def never(line, braced=False):
    """An edit that puts the statement opening ``line`` behind NEVER, in
    braces where ``braced`` (a one-line statement before an ``else``)."""
    body = line.lstrip()
    new = NEVER + body
    return line, line[:len(line) - len(body)] + (
        "{ " + new + " }" if braced else new)


S64 = never("        wgmma_ss_n64(s, dc, db, sl > 0 || ks > 0);", True)
S128 = never("        wgmma_ss_n128(s, dc, db, sl > 0 || ks > 0);", True)
CHT = never("        wgmma_ss_n64(y, sw128_desc(cs_s + c * 64 * 128 + "
            "ks * 32, 16, 1024),")
STATE = never("            wgmma_rs_n64(h[hs], xf[kk],")
MX = never("    wgmma_rs_n64(y, mf[kk], sw128_desc(xt + kk * 16 * 128, "
           "kTileBytes, 1024),")
VARIANTS = {
    "as_is": [],
    "three_chunk_stages": [("constexpr int kChunkStages = 2;",
                            "constexpr int kChunkStages = 3;")],
    "no_s": [S64, S128],
    "no_cht": [CHT],
    "no_state": [STATE],
    "no_mx": [MX],
    "no_products": [S64, S128, CHT, STATE, MX],
    "no_ystore": [never("    tma_store(ty, w.ytile(c), w.p0, w.head, row0, "
                        "w.b);")],
    "no_dt_load": [("    d[j] = tt < rows ? dtb[(long long)tt * a.H] : 0.f;",
                    "    d[j] = tt < rows ? 0.01f : 0.f;")],
}
CHECKED = {"as_is", "three_chunk_stages"}


def build_variant(name):
    """The path of the variant's library and nvcc's report, built from the
    edited source."""
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"ablate_k5: {name}: the source no longer "
                             f"holds {old!r} once")
        src = src.replace(old, new)
    out_dir = os.path.join(ROOT, "build", "ablate_k5")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", lib, path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"ablate_k5: {name} does not build:\n{proc.stdout}")
    return lib, proc.stdout


def use_library(lib):
    """Route the port's wrapper through ``lib``'s C entry."""
    import ctypes
    from repro_torch.kernels.ssd_scan import kernel
    fn = ctypes.CDLL(lib).ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kernel._fn = fn


def main(argv=None):
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import chip_smoke
    from compare_k5 import SHAPES
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "k5_ablate.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k5: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    for name, (_, log) in built.items():
        print(f"[k5-ablate-build] {name}: " + " | ".join(
            line.strip() for line in log.splitlines()
            if any(k in line for k in ("Function properties", "spill",
                                       "Used", "C75"))),
            flush=True)
    shapes = {k: SHAPES[k] for k in ("mamba2-1.3b", "zamba2-1.2b")}
    tol = chip_smoke.SSD_TOL["bfloat16"]
    inputs = {name: chip_smoke.ssd_operands(torch, *shape, "bfloat16",
                                            seed=300 + i)
              for i, (name, shape) in enumerate(shapes.items())}
    rows = []
    for variant in [*VARIANTS, "as_is"]:
        use_library(built[variant][0])
        for name, operands in inputs.items():
            call = lambda: ops.ssd_scan(*operands, chunk=128,
                                        return_state=True)
            row = {"variant": variant, "shape": name}
            if variant in CHECKED:
                y, state = call()
                want_y, want_state = ssd_reference(*operands, chunk=128)
                ratio = max(
                    chip_smoke.allclose_ratio(torch, y, want_y, tol),
                    chip_smoke.allclose_ratio(torch, state, want_state, tol))
                if not ratio <= 1.0:
                    raise SystemExit(f"ablate_k5: {variant} at {name}: "
                                     f"{ratio} of the tolerance")
                row["tol_ratio"] = ratio
            spread = chip_smoke.device_spread(torch, call, "ssd_scan_")
            row.update(device_ms=spread and spread["median"],
                       device_ms_min=spread and spread["min"],
                       device_ms_max=spread and spread["max"],
                       device_samples=spread and spread["samples"],
                       ms=chip_smoke.time_ms(torch, call, samples=10,
                                             inner=10),
                       bound_ms=chip_smoke.ssd_bound(*shapes[name],
                                                     "bfloat16")[0])
            rows.append(row)
            print("[k5-ablate] " + json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
