"""ResNet for the port — counterpart of ``polyaxon_tpu/models/resnet.py``.

The parameter tree is the JAX package's: HWIO conv kernels, BatchNorm
scale and bias, a dense head, and the batch statistics as a separate tree
(``extra`` to the trainer). Images come in NHWC. Inside, activations are
NCHW tensors in channels-last memory, so that cuDNN's convolutions take
them as they lie on the card.

The numerics follow the JAX model:
- ``"SAME"`` padding as XLA pads it, ``lo = total // 2`` and ``hi = total -
  lo``: asymmetric at stride 2 (the 7x7/2 stem on 224 pads (2, 3), a 3x3/2
  conv (0, 1)), and the 3x3/2 max-pool pads (0, 1) with -inf. Symmetric
  padding would shift every strided output by one pixel.
- BatchNorm in f32 with the biased batch variance, in two passes as
  ``jnp.var`` takes it (the mean, then the mean of squared deviations);
  the running statistics move as ``momentum * old + (1 - momentum) *
  batch``. Over a mesh both sums are the whole batch's, summed over the
  batch ranks by a differentiable all-reduce, as XLA's psum makes them; on
  one rank the same expression gives the same bits as no mesh. Every
  ``model`` and ``context`` rank computes the same forward on the same
  rows (the params are replicated): nothing is summed over those axes.
- Convolutions in ``cfg.dtype`` (bf16); pooling and the head in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..parallel.blocks import Law, init_tree, keyed
from ..parallel.mesh import TOKEN_AXES


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    small_inputs: bool = False  # CIFAR: 3x3 stem, no max-pool


RESNET50 = ResNetConfig()
RESNET50_CIFAR = ResNetConfig(num_classes=10, small_inputs=True)
RESNET18_CIFAR = ResNetConfig(stage_sizes=(2, 2, 2, 2), num_classes=10,
                              small_inputs=True, width=16)

CONFIGS = {"resnet50": RESNET50, "resnet50-cifar": RESNET50_CIFAR,
           "resnet18-cifar": RESNET18_CIFAR}

_BOTTLENECK = 4


def laws(cfg: ResNetConfig) -> tuple[dict, dict]:
    """(params, batch_stats) laws (``parallel/blocks.py``): He-normal
    convs, BatchNorm scale 1 and bias 0, running mean 0 and variance 1, the
    head normal at 0.01 — the JAX package's law. Each leaf is one slice."""
    params: dict = {}
    stats: dict = {}

    def conv(name, kh, kw, cin, cout):
        params[name] = {"w": Law((kh, kw, cin, cout), "normal",
                                 (2.0 / (kh * kw * cin)) ** 0.5)}

    def bn(name, c):
        params[name] = {"bias": Law((c,), "zeros"), "scale": Law((c,), "ones")}
        stats[name] = {"mean": Law((c,), "zeros"), "var": Law((c,), "ones")}

    w = cfg.width
    stem_k = 3 if cfg.small_inputs else 7
    conv("stem", stem_k, stem_k, 3, w)
    bn("stem_bn", w)
    cin = w
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = w * (2 ** si)
        cout = cmid * _BOTTLENECK
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}"
            conv(f"{pre}_c1", 1, 1, cin, cmid)
            bn(f"{pre}_bn1", cmid)
            conv(f"{pre}_c2", 3, 3, cmid, cmid)
            bn(f"{pre}_bn2", cmid)
            conv(f"{pre}_c3", 1, 1, cmid, cout)
            bn(f"{pre}_bn3", cout)
            if bi == 0:
                conv(f"{pre}_proj", 1, 1, cin, cout)
                bn(f"{pre}_projbn", cout)
            cin = cout
    params["head"] = {"b": Law((cfg.num_classes,), "zeros"),
                      "w": Law((cin, cfg.num_classes), "normal", 0.01)}
    return keyed(params), keyed(stats, "extra/")


def init(cfg: ResNetConfig, *, seed: int = 0, device: Any) -> tuple[dict, dict]:
    """Returns (params, batch_stats) by :func:`laws`, each leaf from a
    ``torch.Generator`` of its own seeded from ``seed`` and its path."""
    params, stats = laws(cfg)
    return init_tree(params, seed, device), init_tree(stats, seed, device)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (lo, hi)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    hlo, hhi = same_pads(x.shape[2], k, stride)
    wlo, whi = same_pads(x.shape[3], k, stride)
    if hlo or hhi or wlo or whi:
        x = F.pad(x, (wlo, whi, hlo, hhi), value=value)
    return x


def _conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of NCHW ``x`` with an HWIO kernel, in x's dtype."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(_pad_same(x, w.shape[2], stride), w, stride=stride)


def _bn(x, params, stats, cfg: ResNetConfig, train: bool, new_stats: dict, name: str,
        mesh=None):
    x32 = x.float()
    col = lambda t: t[None, :, None, None]  # noqa: E731
    if train:
        n = x32.numel() // x32.shape[1]

        def over_batch(local_sum):
            return local_sum / n if mesh is None else mesh.batch_mean(local_sum, n)

        mean = over_batch(x32.sum(dim=(0, 2, 3)))
        var = over_batch(((x32 - col(mean)) ** 2).sum(dim=(0, 2, 3)))
        m = cfg.bn_momentum
        new_stats[name] = {"mean": m * stats[name]["mean"] + (1 - m) * mean.detach(),
                           "var": m * stats[name]["var"] + (1 - m) * var.detach()}
    else:
        mean, var = stats[name]["mean"], stats[name]["var"]
    inv = torch.rsqrt(var + cfg.bn_eps)
    out = (x32 - col(mean)) * col(inv) * col(params[name]["scale"]) + col(params[name]["bias"])
    return out.to(x.dtype)


def apply(params: dict, stats: dict, images: torch.Tensor, cfg: ResNetConfig, *,
          train: bool = True, mesh=None) -> tuple[torch.Tensor, dict]:
    """images [B, H, W, 3] -> (logits [B, classes] f32, updated batch stats).
    With a ``mesh`` the images are this rank's rows of the batch and the
    batch statistics are the whole batch's."""
    new_stats: dict = dict(stats)

    def bn(y, name):
        return _bn(y, params, stats, cfg, train, new_stats, name, mesh)

    x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NHWC memory: channels-last NCHW
    x = _conv(x, params["stem"], stride=1 if cfg.small_inputs else 2)
    x = F.relu(bn(x, "stem_bn"))
    if not cfg.small_inputs:
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            pre = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            residual = x
            y = F.relu(bn(_conv(x, params[f"{pre}_c1"]), f"{pre}_bn1"))
            y = F.relu(bn(_conv(y, params[f"{pre}_c2"], stride=stride), f"{pre}_bn2"))
            y = bn(_conv(y, params[f"{pre}_c3"]), f"{pre}_bn3")
            if f"{pre}_proj" in params:
                residual = bn(_conv(x, params[f"{pre}_proj"], stride=stride), f"{pre}_projbn")
            x = F.relu(y + residual)
    x = x.float().mean(dim=(2, 3))
    logits = torch.matmul(x, params["head"]["w"]) + params["head"]["b"]
    return logits.float(), new_stats


def flops_per_image(cfg: ResNetConfig, image_size: int) -> float:
    """Training FLOPs per image (2 x MACs forward, x3 for forward and
    backward), walking the same conv schedule as :func:`apply`."""
    total = 0.0

    def conv(kh, kw, cin, cout, hw, stride=1):
        nonlocal total
        out = hw // stride
        total += 2.0 * kh * kw * cin * cout * out * out
        return out

    w = cfg.width
    stem_k = 3 if cfg.small_inputs else 7
    hw = conv(stem_k, stem_k, 3, w, image_size, stride=1 if cfg.small_inputs else 2)
    if not cfg.small_inputs:
        hw //= 2  # max-pool
    cin = w
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = w * (2 ** si)
        cout = cmid * _BOTTLENECK
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            conv(1, 1, cin, cmid, hw)
            hw2 = conv(3, 3, cmid, cmid, hw, stride=stride)
            conv(1, 1, cmid, cout, hw2)
            if bi == 0:
                conv(1, 1, cin, cout, hw, stride=stride)
            hw = hw2
            cin = cout
    total += 2.0 * cin * cfg.num_classes
    return 3.0 * total


def batch_mean(values: torch.Tensor, mesh=None, axes: tuple = TOKEN_AXES) -> torch.Tensor:
    """The mean of ``values`` (their sum over their count); with a
    ``mesh``, this rank's share of the whole batch's mean (its sum over the
    count summed over ``axes``: the ranks that split the batch's terms)."""
    count = torch.full((), float(values.numel()), device=values.device)
    return values.sum() / (count if mesh is None else mesh.batch_count(count, axes))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        mesh=None, axes: tuple = TOKEN_AXES) -> torch.Tensor:
    """Mean cross entropy of [B, classes] logits (a rank's share of the
    batch's under a ``mesh``, shared over ``axes``)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return batch_mean(logz - gold, mesh, axes)
