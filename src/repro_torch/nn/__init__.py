"""The layers the port's networks and language models use, in the JAX
package's layout."""

from repro_torch.nn.layers import (Linear, LayerNorm, RMSNorm, SwiGLU,
                                   linear, layernorm, rmsnorm, embedding,
                                   embedding_logits, swiglu)
