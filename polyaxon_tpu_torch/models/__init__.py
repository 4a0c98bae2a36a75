"""Model zoo of the port: the JAX package's families on their own configs —
Llama and GPT-2 (causal LM), BERT (masked LM) and ViT on the shared
transformer layout, and ResNet."""

from . import bert, gpt2, llama, resnet, transformer, vit
from .transformer import TransformerConfig

# name -> (family, config) for runtime lookup (`model: ...` spec key); the
# family selects the Task in train/tasks.py
REGISTRY: dict = {name: ("lm", cfg)
                  for mod in (llama, gpt2) for name, cfg in mod.CONFIGS.items()}
REGISTRY.update({name: ("mlm", cfg) for name, cfg in bert.CONFIGS.items()})
REGISTRY.update({name: ("vit", cfg) for name, cfg in vit.CONFIGS.items()})
REGISTRY.update({name: ("resnet", cfg) for name, cfg in resnet.CONFIGS.items()})

__all__ = ["bert", "gpt2", "llama", "resnet", "transformer", "vit",
           "TransformerConfig", "REGISTRY"]
