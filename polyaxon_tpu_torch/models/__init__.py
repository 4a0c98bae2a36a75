"""Model zoo of the port: the dense Llama and GPT-2 causal-LM configs on
the shared transformer layout. BERT, ViT and ResNet wait for ROADMAP A11."""

from . import gpt2, llama, transformer
from .transformer import TransformerConfig

# name -> (family, config) for runtime lookup (`model: ...` spec key)
REGISTRY: dict = {name: ("lm", cfg)
                  for mod in (llama, gpt2) for name, cfg in mod.CONFIGS.items()}

__all__ = ["gpt2", "llama", "transformer", "TransformerConfig", "REGISTRY"]
