"""The port's input-shape grid (``configs/shapes.py``) against the JAX
package's: ``SHAPES``; ``shape_supported`` for every arch and shape;
``input_specs`` (meta tensors where the reference gives
``ShapeDtypeStruct``s) with the reference's names, order, shapes and
dtypes for every arch and shape, at full width and scale 16 (phase 25's
train batches) and on the SMOKE configs at scale 64; and
``concrete_inputs`` byte for byte for every arch's SMOKE config, which
holds the bf16 rounding of the float64 normal draws (``torch``'s and
``jnp.asarray``'s) and the M-RoPE text positions."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import list_archs
from repro.configs import shapes as j_shapes

from repro_torch.configs import (SHAPES, concrete_inputs, get_config,
                                 get_smoke_config, input_specs,
                                 shape_supported)

ARCHS = list_archs()
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_the_grid_is_the_reference_s():
    assert SHAPES == j_shapes.SHAPES
    for arch in ARCHS:
        for shape_id in SHAPES:
            assert shape_supported(get_config(arch), shape_id) == \
                j_shapes.shape_supported(j_config(arch), shape_id), (
                    arch, shape_id)
    # the sub-quadratic archs run long_500k, the others are refused
    runs = {a for a in ARCHS if shape_supported(get_config(a),
                                                "long_500k")[0]}
    assert runs == {"mamba2-1.3b", "zamba2-1.2b", "mixtral-8x22b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_reference_s(arch):
    for cfgs, scale in (((get_config(arch), j_config(arch)), 16),
                        ((get_smoke_config(arch), j_smoke(arch)), 64)):
        for shape_id in SHAPES:
            got = input_specs(cfgs[0], shape_id, scale=scale)
            want = j_shapes.input_specs(cfgs[1], shape_id, scale=scale)
            assert list(got) == list(want), (arch, shape_id)
            for name, w in want.items():
                g = got[name]
                assert g.device.type == "meta"
                assert tuple(g.shape) == w.shape, (arch, shape_id, name)
                assert g.dtype == DTYPES[jnp.dtype(w.dtype)], name


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_inputs_equal_the_reference_s_byte_for_byte(arch):
    for shape_id in SHAPES:
        for seed in (0, 3):
            got = concrete_inputs(get_smoke_config(arch), shape_id,
                                  scale=64, seed=seed, device="cpu")
            want = j_shapes.concrete_inputs(j_smoke(arch), shape_id,
                                            scale=64, seed=seed)
            assert list(got) == list(want)
            for name, w in want.items():
                g, w = got[name], np.asarray(w)
                assert g.device.type == "cpu" and tuple(g.shape) == w.shape
                assert g.dtype == DTYPES[w.dtype], name
                bits = (g.view(torch.int16).numpy() if g.dtype ==
                        torch.bfloat16 else g.numpy())
                assert bits.tobytes() == w.tobytes(), (arch, shape_id, name)
