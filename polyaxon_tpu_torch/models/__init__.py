"""Model zoo of the port: the dense Llama causal-LM configs on the shared
transformer layout."""

from . import llama, transformer
from .transformer import TransformerConfig

# name -> (family, config) for runtime lookup (`model: ...` spec key)
REGISTRY: dict = {name: ("lm", cfg) for name, cfg in llama.CONFIGS.items()}

__all__ = ["llama", "transformer", "TransformerConfig", "REGISTRY"]
