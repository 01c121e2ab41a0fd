"""Parameters and AdamW state between the JAX package's layout and the
port's.

The JAX package keeps the agent as a nested dict ``{"policy": {...},
"value": {...}}`` of arrays (``embed.w`` is (d_in, d_out)); the port keeps
an ``nn.ModuleDict`` whose parameter names are the same key paths joined by
"." (``policy.embed.w``) with the same shapes, so converting is a rename.
Inputs are numpy arrays (``np.asarray`` of a JAX leaf works); outputs on
the JAX side are numpy arrays.

The language models' parameters (``lm_params_from_jax``/``lm_params_to_jax``)
are the same rename plus an unstack: the reference keeps each stack of
layers as one tree with leading stacked axes (``layers.attn.wq.w`` is
(L, d, H·D); the hybrid's ``groups.*`` are (G, attn_every, ...)), the port
one module per layer (``layers.3.attn.wq.w``, ``groups.1.2.mixer.D``,
``dec_layers.0.cross_attn.wk.w``, ``layers.0.attn.wuk``).
bf16 leaves travel as float32 NumPy arrays (every bf16 value is exact in
float32), so the port needs no NumPy bf16 type.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import networks as nets
from repro_torch.device import resolve_device
from repro_torch.models.api import MODULES


def flatten_tree(tree, prefix=""):
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten_tree(flat):
    """{"a.b.c": leaf} -> nested dict."""
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _modules_for(tree):
    pol, val = tree["policy"], tree["value"]
    obs_dim, hidden = np.shape(pol["embed"]["w"])
    act_dim = np.shape(pol["mean"]["w"])[1]
    if "gru" in pol:
        return nn.ModuleDict({
            "policy": nets.RNNPolicyNet(
                obs_dim=obs_dim, act_dim=act_dim, hidden=hidden,
                rnn_hidden=np.shape(pol["gru"]["wz"]["w"])[1]),
            "value": nets.RNNValueNet(
                obs_dim=obs_dim, hidden=np.shape(val["embed"]["w"])[1],
                rnn_hidden=np.shape(val["gru"]["wz"]["w"])[1]),
        })
    return nn.ModuleDict({
        "policy": nets.PolicyNet(obs_dim=obs_dim, act_dim=act_dim,
                                 hidden=hidden),
        "value": nets.ValueNet(obs_dim=obs_dim,
                               hidden=np.shape(val["embed"]["w"])[1]),
    })


def params_from_jax(tree, *, device=None) -> nn.ModuleDict:
    """JAX agent params ``{"policy", "value"}`` -> the port's ModuleDict of
    PolicyNet/ValueNet (or the GRU pair, when the policy has a ``gru``),
    on ``device`` (None: the CUDA device)."""
    modules = _modules_for(tree)
    state = {n: torch.as_tensor(np.array(v, np.float32))
             for n, v in flatten_tree(tree).items()}
    modules.load_state_dict(state, strict=True)
    return modules.to(resolve_device(device))


def params_to_jax(params: nn.Module):
    """The port's ModuleDict -> the JAX package's nested dict of numpy."""
    return unflatten_tree({n: p.detach().cpu().numpy()
                           for n, p in params.named_parameters()})


def adamw_state_from_jax(opt, *, device=None):
    """JAX ``adamw_init``/``adamw_update`` state -> the port's
    ``{"m": {name: tensor}, "v": {...}, "step": int32 tensor}``."""
    device = resolve_device(device)

    def flat(tree):
        return {n: torch.as_tensor(np.array(v, np.float32), device=device)
                for n, v in flatten_tree(tree).items()}

    return {"m": flat(opt["m"]), "v": flat(opt["v"]),
            "step": torch.as_tensor(np.array(opt["step"], np.int32),
                                    device=device)}


def adamw_state_to_jax(opt):
    """The port's AdamW state -> the JAX package's nested dicts of numpy."""
    def nested(flat):
        return unflatten_tree({n: t.detach().cpu().numpy()
                               for n, t in flat.items()})

    return {"m": nested(opt["m"]), "v": nested(opt["v"]),
            "step": np.asarray(opt["step"].cpu().numpy(), np.int32)}


# the reference's stacked subtrees: name -> number of leading stacked axes
_STACKS = {"layers": 1, "dense_layers": 1, "tail": 1, "groups": 2,
           "enc_layers": 1, "dec_layers": 1}


def reference_name(name):
    """The reference's key path of a port parameter name: the layer
    indices of a ``_STACKS`` stack dropped (``layers.3.attn.wq.w`` ->
    ``layers.attn.wq.w``, ``groups.1.2.mixer.D`` -> ``groups.mixer.D``);
    every other name is its own."""
    stack, *rest = name.split(".")
    depth = _STACKS.get(stack, 0)
    if depth and all(p.isdigit() for p in rest[:depth]):
        rest = rest[depth:]
    return ".".join([stack, *rest])


def lm_params_from_jax(cfg, tree, *, device=None) -> nn.Module:
    """The JAX package's decoder (MLA and qkv biases included), ssm, hybrid
    or enc-dec params (nested dict of NumPy arrays, each stack of
    ``_STACKS`` with its leading stacked axes) -> the port's module of
    ``cfg.family`` (``models.api.MODULES``) on
    ``device`` (None: the CUDA device). bf16 leaves become bf16 tensors,
    float32 leaves float32 ones."""
    state = {}
    for name, leaf in flatten_tree(tree).items():
        bf16 = np.asarray(leaf).dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(leaf, np.float32))
        t = t.to(torch.bfloat16) if bf16 else t
        stack, _, rest = name.partition(".")
        depth = _STACKS.get(stack, 0)
        if depth:
            state.update({".".join([stack, *map(str, idx), rest]):
                          t[idx].clone()
                          for idx in np.ndindex(*t.shape[:depth])})
        else:
            state[name] = t
    with torch.device("meta"):   # the structure only; no weights drawn
        model = MODULES[cfg.family](cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(resolve_device(device))


def lm_params_to_jax(model: nn.Module):
    """The port's LM module (``DecoderLM``, ``SSMLM``, ``HybridLM`` or
    ``EncDecLM``) -> the JAX package's nested dict, each stack's layers stacked on its leading axes,
    as float32 NumPy arrays (cast bf16 leaves back with
    ``jnp.asarray(x, jnp.bfloat16)``; float32 leaves stay float32; the
    values are exact)."""
    flat, stacks = {}, {}
    for name, p in model.named_parameters():
        arr = p.detach().to(torch.float32).cpu().numpy()
        stack = name.split(".", 1)[0]
        depth = _STACKS.get(stack, 0)
        if depth:
            *idx, rest = name.split(".", depth + 1)[1:]
            stacks.setdefault((stack, rest), {})[tuple(map(int, idx))] = arr
        else:
            flat[name] = arr
    for (stack, rest), per_layer in stacks.items():
        shape = tuple(max(i[a] for i in per_layer) + 1
                      for a in range(_STACKS[stack]))
        flat[f"{stack}.{rest}"] = np.stack(
            [per_layer[idx] for idx in np.ndindex(*shape)]).reshape(
                shape + next(iter(per_layer.values())).shape)
    return unflatten_tree(flat)
