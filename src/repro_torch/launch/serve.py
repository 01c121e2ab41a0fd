"""Batched serving (port of ``repro.launch.serve``): prefill a batch
of requests, then step the greedy decode loop, on the CUDA device. The
command line serves with ``attn_backend="pallas"`` (the reference's keeps
each config's backend), the port's flash-attention kernel on the prefill
of every causal self-attention layer, sliding-window ones included
(mixtral), and the enc-dec's decoder (seamless); an MLA config
(deepseek-v2) keeps its own backend ('chunked'), since the kernel takes
one head dim for q, k and v. The Mamba2 layers (mamba2-1.3b, and
zamba2-1.2b's beside its shared attention block) run the SSD scan kernel
on every prefill whatever the backend. The archs: smollm-135m,
deepseek-7b, granite-34b, chatglm3-6b (dense), mixtral-8x22b and
deepseek-v2-236b (moe), qwen2-vl-72b (vlm: random vision embeddings in
place of the first min(256, prompt_len // 2) tokens), mamba2-1.3b (ssm),
zamba2-1.2b (hybrid), seamless-m4t-large-v2 (encdec: random frame
embeddings, prompt_len // 4 of them, at least 8).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --batch 8 --prompt-len 1024 --gen 32

mixtral-8x22b, granite-34b, qwen2-vl-72b and deepseek-v2-236b do not fit
one card at their published depth; ``chip_smoke.py`` serves them cut in
depth (``cfg.replace(n_layers=...)``), at full width; ``--smoke`` serves
any arch's SMOKE config.
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


def served_config(cfg):
    """The config the command line serves: ``attn_backend="pallas"``,
    except for an MLA config, which keeps its own backend."""
    return cfg if cfg.use_mla else cfg.replace(attn_backend="pallas")


def draw_prompts(cfg, batch, prompt_len, seed):
    """The reference serve's NumPy draws from ``seed``: the tokens, then
    the enc-dec's frames or the VLM's vision embeddings (float64, cast to
    bf16 on the device by ``serve``)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(batch, prompt_len),
                                  dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            0, 1, (batch, max(prompt_len // cfg.src_ratio, 8), cfg.d_model))
    if cfg.family == "vlm":
        V = min(cfg.n_vision_tokens, prompt_len // 2)
        out["vision_embeds"] = rng.normal(0, 1, (batch, V, cfg.d_model))
    return out


def prompts_on(draws, device):
    """``draw_prompts``' arrays as the model's batch on ``device``: int32
    tokens, bf16 embeddings."""
    return {k: torch.from_numpy(v).to(
        device, None if k == "tokens" else torch.bfloat16)
        for k, v in draws.items()}


def serve(cfg, *, batch=4, prompt_len=32, gen=16, seed=0, device=None,
          params=None):
    """Greedy generation of ``gen`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (``draw_prompts``: the reference's NumPy draws
    from ``seed``) with ``params``, or else the port's own parameters from
    ``seed``. Runs on the CUDA device unless ``device`` names another.
    Returns (tokens (batch, gen) int32, timings) where the timings are
    wall seconds ended by a device synchronize."""
    device = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(seed, device=device)
    prompts = prompts_on(draw_prompts(cfg, batch, prompt_len, seed), device)

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
    cfg = served_config(cfg)
    toks, info = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen)
    print(f"[serve] generated {tuple(toks.shape)} tokens; "
          f"prefill={info['prefill_s']:.2f}s decode={info['decode_s']:.2f}s "
          f"({info['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
