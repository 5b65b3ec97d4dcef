"""Model families sized to the benchmark workloads (BASELINE.json).

Port of ``sda_tpu/models/families.py`` (flax there) as ``torch.nn``
modules:

- ``LeNet``        — the classic 28x28 convnet, ~61k params (lenet-60k).
- ``MobileLite``   — depthwise-separable inverted-residual stack; at the
                     default width it lands at 3,731,890 params
                     (mobilenet-3.5m).
- ``LoRAMLP``      — a frozen wide MLP with trainable rank-r adapters; the
                     *adapter* vector is what gets aggregated (lora-13m).

Each family keeps the reference's conventions, so the same arrays feed
both packages and ``convert.family_params_from_flax`` carries weights
across unchanged in value:

- inputs are NHWC (``[N, H, W, C]``) and outputs are logits ``[N,
  classes]``; LeNet flattens its last feature map in H, W, C order;
- submodules and parameters bear flax's names (``Conv_0``,
  ``GroupNorm_1``, ``_InvertedResidual_3``, ``base_0``, ``lora_a_0``);
- "SAME" convolutions pad as flax does: the total pad is split with the
  smaller half first, so a stride-2 3x3 conv on an even size pads (0, 1);
- ``GroupNorm`` uses flax's epsilon, 1e-6;
- kernels start lecun-normal (a truncated normal of variance 1/fan_in),
  biases zero, GroupNorm scales one, ``lora_a_i`` normal(0.02) and
  ``lora_b_i`` zero (the adapters start as a no-op);
- the forward runs in full float32 on any device
  (``precision.float32_scope``: no TF32 in convolutions or matrix
  products).

Every builder takes ``device`` (CUDA unless ``"cpu"``; ``"meta"`` builds
the shapes without drawing anything, for sizing) and ``generator`` (a CPU
``torch.Generator`` the initial values are drawn from; seed 0 when None).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .precision import float32_scope

__all__ = ["LeNet", "MobileLite", "LoRAMLP", "lora_adapter_params",
           "merge_lora_params", "param_count"]

#: flax's GroupNorm epsilon (torch's default is 1e-5)
GROUPNORM_EPS = 1e-6
#: the standard deviation of a unit normal truncated to [-2, 2]
#: (flax's ``variance_scaling`` divides by it)
_TRUNC_STD = .87962566103423978


def param_count(params) -> int:
    """Total leaf elements of a module or of a tree of tensors (meta
    tensors included)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    from .encoding import _tree_leaves

    return sum(int(np.prod(tuple(np.shape(leaf)), dtype=np.int64))
               for leaf in _tree_leaves(params, []))


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's "SAME" padding of one spatial axis: output ceil(size /
    stride), the total pad split with the smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _SameConv(nn.Conv2d):
    """A ``padding="SAME"`` convolution (flax's split, asymmetric at
    stride 2 on an even size) on NCHW tensors."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1, bias=True):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[2], kh, sh)
        left, right = _same_pads(x.shape[3], kw, sw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def _init_params(module: nn.Module, generator) -> None:
    """The reference's initializers, drawn in module order."""
    for sub in module.modules():
        if isinstance(sub, nn.Conv2d):
            kh, kw = sub.kernel_size
            _lecun_normal_(sub.weight, kh * kw * sub.in_channels // sub.groups,
                           generator)
        elif isinstance(sub, nn.Linear):
            _lecun_normal_(sub.weight, sub.in_features, generator)
        elif isinstance(sub, nn.GroupNorm):
            nn.init.ones_(sub.weight)
        else:
            continue
        if sub.bias is not None:
            nn.init.zeros_(sub.bias)
    for name, param in module.named_parameters():
        if name.startswith("lora_a_"):
            nn.init.normal_(param, 0.0, 0.02, generator=generator)
        elif name.startswith("lora_b_"):
            nn.init.zeros_(param)


def _place(module: nn.Module, device, generator) -> None:
    """Give a module built on the meta device its values: drawn on the host
    from ``generator`` and moved to ``device`` (kept as shapes on meta)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return
    module.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _init_params(module, generator)
    module.to(dev)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class LeNet(nn.Module):
    """LeNet-5-shaped convnet for 28x28x1 inputs (~61k params). torch
    sizes the first dense layer at construction (flax at its first call):
    the 5x5x16w feature map of a 28x28 input."""

    def __init__(self, num_classes: int = 10, width: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        with torch.device("meta"):
            self.Conv_0 = _SameConv(1, 6 * w, 5)
            self.Conv_1 = nn.Conv2d(6 * w, 16 * w, 5)
            self.Dense_0 = nn.Linear(5 * 5 * 16 * w, 120 * w)
            self.Dense_1 = nn.Linear(120 * w, 84 * w)
            self.Dense_2 = nn.Linear(84 * w, num_classes)
        _place(self, device, generator)

    @float32_scope()
    def forward(self, x):
        x = F.relu(F.avg_pool2d(self.Conv_0(_nchw(x)), 2))
        x = F.relu(F.avg_pool2d(self.Conv_1(x), 2))
        # flax flattens NHWC: H, W, C order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class _InvertedResidual(nn.Module):
    """MobileNetV2-style expand -> depthwise -> project block (NCHW)."""

    def __init__(self, cin: int, channels: int, expand: int = 4,
                 stride: int = 1):
        super().__init__()
        hidden = cin * expand
        self.Conv_0 = nn.Conv2d(cin, hidden, 1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(1, hidden, eps=GROUPNORM_EPS)
        self.Conv_1 = _SameConv(hidden, hidden, 3, stride=stride,
                                groups=hidden, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(1, hidden, eps=GROUPNORM_EPS)
        self.Conv_2 = nn.Conv2d(hidden, channels, 1, bias=False)
        self.GroupNorm_2 = nn.GroupNorm(1, channels, eps=GROUPNORM_EPS)
        self.residual = stride == 1 and cin == channels

    def forward(self, x):
        h = F.relu6(self.GroupNorm_0(self.Conv_0(x)))
        h = F.relu6(self.GroupNorm_1(self.Conv_1(h)))
        h = self.GroupNorm_2(self.Conv_2(h))
        return h + x if self.residual else h


class MobileLite(nn.Module):
    """Depthwise-separable convnet in the MobileNetV2 spirit.

    The default (width=40, blocks below) has 3,731,890 parameters for
    32x32x3 inputs — the mobilenet-3.5m benchmark vector. GroupNorm stands
    in for BatchNorm so a participant's update is a pure function of its
    local batch (no running statistics to aggregate out-of-band).
    """

    def __init__(self, num_classes: int = 10, width: int = 40,
                 block_channels: Sequence[int] = (16, 24, 40, 80, 112, 192,
                                                  320),
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        with torch.device("meta"):
            self.Conv_0 = _SameConv(3, w, 3, stride=2, bias=False)
            self.GroupNorm_0 = nn.GroupNorm(1, w, eps=GROUPNORM_EPS)
            cin, blocks = w, []
            for i, c in enumerate(block_channels):
                stride = 2 if i in (1, 2, 4) else 1
                blocks.append(_InvertedResidual(cin, c * w // 32,
                                                stride=stride))
                blocks.append(_InvertedResidual(c * w // 32, c * w // 32))
                cin = c * w // 32
            for i, block in enumerate(blocks):
                self.add_module(f"_InvertedResidual_{i}", block)
            self.blocks = blocks
            self.Conv_1 = nn.Conv2d(cin, 40 * w, 1, bias=False)
            self.GroupNorm_1 = nn.GroupNorm(1, 40 * w, eps=GROUPNORM_EPS)
            self.Dense_0 = nn.Linear(40 * w, num_classes)
        _place(self, device, generator)

    @float32_scope()
    def forward(self, x):
        x = F.relu6(self.GroupNorm_0(self.Conv_0(_nchw(x))))
        for block in self.blocks:
            x = block(x)
        x = F.relu6(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


class LoRAMLP(nn.Module):
    """Wide MLP whose dense layers carry rank-r LoRA adapters.

    Aggregation-relevant split: the *base* params (``base_i``, ``head``)
    are frozen (``requires_grad=False``) and identical on every
    participant; only the adapter params (``lora_a_i``, ``lora_b_i``) are
    trained and securely aggregated. ``lora_adapter_params`` extracts
    that trainable sub-tree; at (features=4096, layers=4, rank=400) on
    28x28 inputs (``in_features=784``) the adapter vector is 11,782,400
    params (`fl/flagship.py` pins the count) — the lora-13m workload.
    """

    def __init__(self, features: int = 4096, layers: int = 4,
                 rank: int = 400, num_classes: int = 10,
                 in_features: int = 784, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = layers
        with torch.device("meta"):
            fan_in = in_features
            for i in range(layers):
                self.add_module(f"base_{i}", nn.Linear(fan_in, features))
                self.register_parameter(f"lora_a_{i}", nn.Parameter(
                    torch.empty(fan_in, rank)))
                self.register_parameter(f"lora_b_{i}", nn.Parameter(
                    torch.empty(rank, features)))
                fan_in = features
            self.head = nn.Linear(features, num_classes)
        _place(self, device, generator)
        for name, param in self.named_parameters():
            param.requires_grad_(name.startswith("lora_"))

    @float32_scope()
    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.layers):
            a, b = getattr(self, f"lora_a_{i}"), getattr(self, f"lora_b_{i}")
            x = F.relu(getattr(self, f"base_{i}")(x) + (x @ a) @ b)
        return self.head(x)


def lora_adapter_params(params) -> dict:
    """The trainable (aggregated) sub-tree of a LoRAMLP: of the module
    (its adapter parameters) or of a param dict (a ``state_dict``, or the
    reference's tree with or without the ``"params"`` level)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    tree = params["params"] if "params" in params else params
    return {k: v for k, v in tree.items() if k.startswith("lora_")}


def merge_lora_params(params, adapters) -> dict:
    """Rebuild a full param tree from frozen base + aggregated adapters."""
    tree = dict(params["params"] if "params" in params else params)
    tree.update(adapters)
    return {"params": tree} if "params" in params else tree
