"""The layers the port's networks use, in the JAX package's layout."""

from repro_torch.nn.layers import Linear, LayerNorm, linear, layernorm
