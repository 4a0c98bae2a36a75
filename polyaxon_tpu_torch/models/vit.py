"""ViT for the port — counterpart of ``polyaxon_tpu/models/vit.py``.

The patch embedding is a reshape and one matrix product (non-overlapping
patches make it a convolution), laid out as the JAX package lays it out:
a patch vector is (ph, pw, c), so converted weights mean the same thing.
The encoder is the shared transformer trunk (``causal=False``, LayerNorm
at eps 1e-6), with a CLS token and a classification head. The patch
embedding and the head run in the encoder's dtype; only the logits are f32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from ..parallel.blocks import Law, init_tree, keyed
from ..parallel.mesh import ShardingRules
from . import transformer
from .transformer import TransformerConfig


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    channels: int = 3
    encoder: TransformerConfig = None  # type: ignore[assignment]

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    def num_params(self) -> int:
        h = self.encoder.hidden
        # the encoder's token table and learned positions are not ViT's:
        # init() drops the one and replaces the other with the patch grid's
        enc = self.encoder.num_params() - self.encoder.vocab_size * h \
            - self.encoder.max_seq * h
        pos = (self.num_patches + 1) * h
        patch = self.patch_dim * h + h
        cls = h
        head = h * self.num_classes + self.num_classes
        return enc + pos + patch + cls + head


def _encoder(hidden, layers, heads, mlp, seq) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=1,  # unused: the trunk takes the patch embeddings
        hidden=hidden, num_layers=layers, num_heads=heads, mlp_dim=mlp,
        max_seq=seq, norm="ln", act="gelu", pos="learned", causal=False,
        use_bias=True, tie_embeddings=True, eps=1e-6, dtype=torch.bfloat16,
    )


VIT_B16 = ViTConfig(encoder=_encoder(768, 12, 12, 3072, 197))
VIT_L16 = ViTConfig(encoder=_encoder(1024, 24, 16, 4096, 197))
VIT_TINY = ViTConfig(
    image_size=32, patch_size=8, num_classes=10,
    encoder=replace(_encoder(64, 2, 4, 128, 17), dtype=torch.float32, attn_impl="dense"),
)

CONFIGS = {"vit-b16": VIT_B16, "vit-l16": VIT_L16, "vit-tiny": VIT_TINY}


def param_laws(cfg: ViTConfig) -> dict:
    """The JAX package's init law (truncated normal at ±2σ, σ = 0.02; CLS
    and biases zero), leaf by leaf (``parallel/blocks.py``): the encoder's
    trunk is the transformer's, without a token table, and its positions
    are ``(num_patches + 1, hidden)``."""
    h = cfg.encoder.hidden
    enc = transformer.param_laws(cfg.encoder)
    del enc["embed"]["tokens"]
    enc["embed"]["pos"] = Law((cfg.num_patches + 1, h), "trunc_normal", 0.02)
    zeros = lambda *shape: Law(shape, "zeros")  # noqa: E731
    return keyed({
        "cls": zeros(1, 1, h),
        "encoder": enc,
        "head": {"b": zeros(cfg.num_classes),
                 "w": Law((h, cfg.num_classes), "trunc_normal", 0.02)},
        "patch": {"b": zeros(h), "w": Law((cfg.patch_dim, h), "trunc_normal", 0.02)},
    })


def init(cfg: ViTConfig, *, seed: int = 0, device: Any) -> dict:
    """Params by :func:`param_laws`, each slice from a ``torch.Generator``
    of its own seeded from ``seed`` and its path."""
    return init_tree(param_laws(cfg), seed, device)


def param_specs(cfg: ViTConfig, rules: Optional[ShardingRules] = None) -> dict:
    """The PartitionSpec tree matching :func:`init`'s params (the JAX
    package's)."""
    rules = rules or ShardingRules()
    enc = transformer.param_specs(cfg.encoder, rules)
    del enc["embed"]["tokens"]
    enc["embed"]["pos"] = rules.spec((None, "embed"))
    return {
        "encoder": enc,
        "patch": {"w": rules.spec((None, "embed")), "b": rules.spec((None,))},
        "cls": rules.spec((None, None, None)),
        "head": {"w": rules.spec(("embed", "classes")), "b": rules.spec(("classes",))},
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], each patch as (ph, pw, c)."""
    b, hh, ww, c = images.shape
    x = images.reshape(b, hh // patch, patch, ww // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // patch) * (ww // patch), patch * patch * c)


def apply(params: dict, images: torch.Tensor, cfg: ViTConfig, mesh=None) -> torch.Tensor:
    """images [B, H, W, C] -> class logits [B, num_classes] (f32). Under a
    ``model`` axis (``mesh``) the encoder's layers run on this rank's
    heads and mlp columns; the patch embedding, CLS and head are
    replicated. Under ``context`` every rank embeds the whole sequence
    (patches + CLS), keeps its chunk at its global positions and runs the
    trunk on it (the non-causal ring or Ulysses); the CLS feature, on the
    first chunk, is summed over the context ranks (its grad too), so every
    rank computes the head on it and holds its share of the loss."""
    dt = cfg.encoder.dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = torch.matmul(x, params["patch"]["w"].to(dt)) + params["patch"]["b"].to(dt)
    cls = params["cls"].to(dt).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    cp = mesh.cp if mesh is not None else 1
    if cp > 1:
        s = x.shape[1] // cp
        x = x[:, mesh.seq_index * s:(mesh.seq_index + 1) * s]
    feats = _encode(params["encoder"], x, cfg, mesh)
    cls_out = feats[:, 0]
    if cp > 1:
        # the graph stays whole on every rank: the ring's backward needs all
        cls_out = mesh.sum_over_context(
            torch.where(torch.tensor(mesh.seq_index == 0, device=cls_out.device), cls_out,
                        torch.zeros_like(cls_out)))
    logits = torch.matmul(cls_out, params["head"]["w"].to(dt)) + params["head"]["b"].to(dt)
    return logits.float()


def _encode(enc_params: dict, x: torch.Tensor, cfg: ViTConfig, mesh=None) -> torch.Tensor:
    """The trunk on the embeddings (positions added at the chunk's global
    offset), then the final norm; no LM head."""
    ecfg = cfg.encoder
    start = transformer._seq_offset(x.shape[1], mesh)
    x = x + enc_params["embed"]["pos"].to(ecfg.dtype)[None, start:start + x.shape[1]]
    x, _ = transformer.run_trunk(x, enc_params["layers"], ecfg, mesh=mesh)
    return transformer._norm(x, enc_params["final_norm"], ecfg)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of [B, classes] logits, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()
