"""Train and serve step factories (port of ``repro.launch.steps``).

The train state is ``{"params": {name: tensor}, "opt": {"m", "v",
"step"}}``: the parameters are a dict keyed by the model module's
parameter names (``layers.3.attn.wq.w``), the form ``optim.adamw`` and the
checkpointer take. A train step binds them into a structure-only copy of
the model (built once on the meta device) as fresh leaves, takes the
loss's gradients with ``torch.autograd.grad`` (the reference's
``jax.value_and_grad``) and returns a new state; no input is modified.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.api import MODULES
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule


def structure(cfg):
    """The model's module with meta tensors: names and shapes, no
    storage."""
    with torch.device("meta"):
        return MODULES[cfg.family](cfg)


def _slots(module):
    """name -> (submodule, attribute) of every parameter."""
    return {n: (module.get_submodule(n.rpartition(".")[0]),
                n.rpartition(".")[2])
            for n, _ in module.named_parameters()}


def make_train_step(cfg, *, peak_lr=3e-4, warmup_steps=100, total_steps=10000,
                    weight_decay=0.1, max_grad_norm=1.0, compress_fn=None):
    """Returns train_step(state, batch) -> (state, metrics). The metrics
    are detached 0-d tensors on the state's device: loss, lr, ce, z_loss,
    aux, grad_norm. ``compress_fn`` ({name: grad} -> {name: grad}, e.g.
    ``runtime.compress.make_int8_compressor()``) is applied to the
    gradients before the optimizer."""
    model = get_model(cfg)
    holder = structure(cfg)
    slots = _slots(holder)

    def train_step(state, batch):
        leaves = {}
        for n, t in state["params"].items():
            mod, attr = slots[n]
            leaves[n] = nn.Parameter(t.detach())
            setattr(mod, attr, leaves[n])
        loss, metrics = model.loss_fn(holder, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            if compress_fn is not None:
                grads = compress_fn(grads)
            lr = cosine_schedule(state["opt"]["step"], peak_lr=peak_lr,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
            params, opt, om = adamw_update(state["params"], grads,
                                           state["opt"], lr=lr,
                                           weight_decay=weight_decay,
                                           max_grad_norm=max_grad_norm)
        out = {"loss": loss.detach(), "lr": lr}
        out.update({k: v.detach() for k, v in metrics.items()})
        out.update(om)
        return {"params": params, "opt": opt}, out

    train_step.module = holder   # the structure the step binds into
    return train_step


def init_state(cfg, seed=0, *, device=None):
    """The model's parameters from ``seed`` (``Model.init``) and fresh AdamW
    moments, on ``device`` (None: the CUDA device)."""
    params = get_model(cfg).init(seed, device=resolve_device(device))
    params = {n: p.detach() for n, p in params.named_parameters()}
    return {"params": params, "opt": adamw_init(params)}


def state_shape(cfg):
    """The train state on the meta device: every leaf's shape and dtype,
    no storage."""
    params = {n: p.detach() for n, p in structure(cfg).named_parameters()}
    return {"params": params, "opt": adamw_init(params)}


def make_prefill_step(cfg, *, ssd_fn=None):
    """One prefill: (last-position logits, the cache). ``ssd_fn`` replaces
    the SSD kernel K5 in the ssm and hybrid prefills (the dry run passes
    the plain scan ``nn.ssd.ssd_chunked``, which the reference's prefill
    runs and which traces on the meta device)."""
    model = get_model(cfg)
    kw = {"ssd_fn": ssd_fn} if ssd_fn is not None else {}

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, **kw)

    return prefill_step


def make_serve_step(cfg, *, temperature=0.0):
    """One decode iteration: the greedy next token and the cache update.
    ``temperature`` is taken and not read, as in the reference, which
    decodes greedily whatever it is given (ROADMAP.md, R7)."""
    model = get_model(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    return serve_step


def cache_shape(cfg, batch, max_len):
    """The serving cache (``init_cache``) on the meta device: every leaf's
    shape and dtype, no storage."""
    return get_model(cfg).init_cache(batch, max_len, device="meta")
