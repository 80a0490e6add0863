"""paddle_tpu_torch.models.resnet — the ResNet family.

Counterpart of ``paddle_tpu/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and ``resnet18/34/50/101/152``, with the
same sublayer names, so the state-dict keys match. ``data_format`` is
``"NCHW"`` (the default, as in the reference) or ``"NHWC"``; it reaches
every convolution, batch norm and pooling layer. Only an NHWC model's
batch norms can go through the port's batch-norm kernels
(``kernels.configure(batch_norm=True)``); train in bf16 through
``amp.auto_cast``.
"""
from __future__ import annotations

from .. import nn


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, in_channels, channels, stride=1, downsample=None,
                 data_format="NCHW"):
        super().__init__()
        df = dict(data_format=data_format)
        self.conv0 = nn.Conv2D(in_channels, channels, 1, bias_attr=False,
                               **df)
        self.bn0 = nn.BatchNorm2D(channels, **df)
        self.conv1 = nn.Conv2D(channels, channels, 3, stride=stride,
                               padding=1, bias_attr=False, **df)
        self.bn1 = nn.BatchNorm2D(channels, **df)
        self.conv2 = nn.Conv2D(channels, channels * 4, 1, bias_attr=False,
                               **df)
        self.bn2 = nn.BatchNorm2D(channels * 4, **df)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn0(self.conv0(x)))
        out = self.relu(self.bn1(self.conv1(out)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, in_channels, channels, stride=1, downsample=None,
                 data_format="NCHW"):
        super().__init__()
        df = dict(data_format=data_format)
        self.conv0 = nn.Conv2D(in_channels, channels, 3, stride=stride,
                               padding=1, bias_attr=False, **df)
        self.bn0 = nn.BatchNorm2D(channels, **df)
        self.conv1 = nn.Conv2D(channels, channels, 3, padding=1,
                               bias_attr=False, **df)
        self.bn1 = nn.BatchNorm2D(channels, **df)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn0(self.conv0(x)))
        out = self.bn1(self.conv1(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    def __init__(self, block, depths, num_classes=1000, in_channels=3,
                 data_format="NCHW"):
        super().__init__()
        self._df = data_format
        df = dict(data_format=data_format)
        self.stem = nn.Sequential(
            nn.Conv2D(in_channels, 64, 7, stride=2, padding=3,
                      bias_attr=False, **df),
            nn.BatchNorm2D(64, **df),
            nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1, **df),
        )
        self.in_ch = 64
        layers = []
        for i, (channels, n) in enumerate(zip([64, 128, 256, 512], depths)):
            stride = 1 if i == 0 else 2
            layers.append(self._make_layer(block, channels, n, stride))
        self.layers = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D(1, **df)
        self.flatten = nn.Flatten(1)
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, channels, blocks, stride):
        df = dict(data_format=self._df)
        downsample = None
        if stride != 1 or self.in_ch != channels * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.in_ch, channels * block.expansion, 1,
                          stride=stride, bias_attr=False, **df),
                nn.BatchNorm2D(channels * block.expansion, **df),
            )
        layers = [block(self.in_ch, channels, stride, downsample, **df)]
        self.in_ch = channels * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.in_ch, channels, **df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.stem(x)
        x = self.layers(x)
        x = self.flatten(self.avgpool(x))
        return self.fc(x)


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)
