"""Model configurations the port can run (see ``registry``) and the
input-shape grid (``shapes``)."""

from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs, ARCHS)
from repro_torch.configs.shapes import (SHAPES, shape_supported, input_specs,
                                        concrete_inputs)
