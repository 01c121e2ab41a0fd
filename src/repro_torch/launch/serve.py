"""Batched serving (port of ``repro.launch.serve``): prefill a batch
of requests, then step the greedy decode loop, on the CUDA device. The
command line serves with ``attn_backend="pallas"`` (the reference's keeps
each config's backend), the port's flash-attention kernel on the prefill
of every attention layer, sliding-window ones included (mixtral); the
Mamba2 layers (mamba2-1.3b, and zamba2-1.2b's beside its shared attention
block) run the SSD scan kernel on every prefill whatever the backend. The
archs: smollm-135m, deepseek-7b, granite-34b, chatglm3-6b (dense),
mixtral-8x22b (moe), mamba2-1.3b (ssm), zamba2-1.2b (hybrid).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --batch 8 --prompt-len 1024 --gen 32

mixtral-8x22b and granite-34b do not fit one card at their published
depth; ``chip_smoke.py`` serves them cut in depth (``cfg.replace(
n_layers=...)``), at full width.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import get_model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, batch=4, prompt_len=32, gen=16, seed=0, device=None,
          params=None):
    """Greedy generation of ``gen`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (the reference's NumPy draws from ``seed``) with
    ``params``, or else the port's own parameters from ``seed``. Runs on
    the CUDA device unless ``device`` names another. Returns (tokens
    (batch, gen) int32, timings) where the timings are wall seconds ended
    by a device synchronize."""
    device = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(seed, device=device)
    rng = np.random.default_rng(seed)
    prompts = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len),
                     dtype=np.int32)).to(device)}

    cache = model.init_cache(batch, prompt_len + gen, device=device)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(cfg)(params, prompts, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0

        serve_step = make_serve_step(cfg)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok, cache = serve_step(params, cache, tok)
            out.append(tok)
        toks = torch.cat(out, dim=1)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help="one of repro_torch.configs.ARCHS")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(attn_backend="pallas")
    toks, info = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen)
    print(f"[serve] generated {tuple(toks.shape)} tokens; "
          f"prefill={info['prefill_s']:.2f}s decode={info['decode_s']:.2f}s "
          f"({info['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
