"""Model configurations the port can run (see ``registry``)."""

from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs, ARCHS)
