"""Serve step factories (port of ``repro.launch.steps``'s prefill and
serve steps). The train step waits for the training slice (ROADMAP.md)."""

from __future__ import annotations

import torch

from repro_torch.models import get_model


def make_prefill_step(cfg):
    model = get_model(cfg)

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_serve_step(cfg):
    """One decode iteration: the greedy next token and the cache update."""
    model = get_model(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    return serve_step
