"""Language models of the port (the dense decoder and ssm families)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.api import get_model, Model
