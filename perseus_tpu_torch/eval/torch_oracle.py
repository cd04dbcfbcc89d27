"""A stock-PyTorch ResNet-18: the test oracle of the training-recipe parity
experiment (``eval/parity.py``).

The port's copy of ``perseus_tpu/eval/torch_oracle.py``: the standard
ResNet-18 (the layer structure, ``state_dict`` key names and semantics of
``torchvision.models.resnet18``; torchvision is not a dependency), wrapped
as the reference's keypoint model wraps it (conv1 for C != 3 input
channels, an fc head of 2 * n_keypoints outputs, the backbone under
``resnet.``). It is built from ``nn`` modules alone (cuDNN convolutions,
``nn.BatchNorm2d``, ``nn.MaxPool2d``) and runs no hand kernel, by design:
it is the independent implementation the port's model is held against.
"""

import torch
from torch import nn

__all__ = ["BasicBlock", "ResNet18", "TorchKeypointCNN"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes),
            )

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet18(nn.Module):
    def __init__(self, num_channels: int = 3, num_outputs: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(num_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512, num_outputs)

    def forward(self, x):
        out = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = torch.flatten(self.avgpool(out), 1)
        return self.fc(out)


class TorchKeypointCNN(nn.Module):
    """The reference's KeypointCNN wrapper: the backbone nested under
    ``resnet.``, so ``state_dict`` keys match the reference checkpoints."""

    def __init__(self, n_keypoints: int = 8, num_channels: int = 3):
        super().__init__()
        self.resnet = ResNet18(num_channels=num_channels, num_outputs=2 * n_keypoints)

    def forward(self, x):
        return self.resnet(x)
