"""ResNet family, counterpart of ``torchdistx_tpu/models/resnet.py``
(BASELINE config 2: ``deferred_init`` of ResNet-50, then materialize on one
card).

Bottleneck (and basic-block) ResNet in NCHW: a 7x7 stride-2 stem, a 3x3
stride-2 max pool, four stages, the global mean and ``fc``.  Parameter and
buffer names are the JAX package's (``layer1.0.conv1.weight``,
``layer1.0.down.0.weight``, ``bn1.running_mean``, ...), so
``interop.load_jax_params`` and ``load_jax_buffers`` carry a JAX model
across one to one.  ``BatchNorm2d`` keeps the JAX semantics: batch
statistics in training mode, the running buffers (never updated) in eval
mode.  The convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX
package's are XLA's ``conv_general_dilated``: no Pallas kernel lies on
this path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn as tnn

from .. import nn
from ..nn import functional as F

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet50", "resnet101"]


def _downsample(cin, cout, stride, kw):
    if stride != 1 or cin != cout:
        return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False, **kw),
                             nn.BatchNorm2d(cout, **kw))
    return nn.Sequential()


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, cin, cout, stride=1, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(cout, **kw)
        self.down = _downsample(cin, cout, stride, kw)

    def forward(self, x):
        idt = self.down(x) if len(self.down) else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + idt)


class Bottleneck(tnn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(width, **kw)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(width, **kw)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False, **kw)
        self.bn3 = nn.BatchNorm2d(cout, **kw)
        self.down = _downsample(cin, cout, stride, kw)

    def forward(self, x):
        idt = self.down(x) if len(self.down) else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idt)


class ResNet(tnn.Module):
    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(64, **kw)
        cin = 64
        stages = []
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block(cin, width, stride=stride, **kw))
                cin = width * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        """(B, 3, H, W) images -> (B, num_classes) logits."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 23, 3], **kw)
