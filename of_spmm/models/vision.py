"""Classic CNN benchmark workloads: VGG16 and AlexNet.

Reference parity: these are the remaining models exercised by the
reference's single-node benchmark smoke (ci/test/1node_benchmark_test.sh:
VGG16 / AlexNet / ResNet50 / BERT-base throughput, 5 iters each).
ResNet50 and BERT live in models/resnet.py / models/transformer.py;
this module completes the set.

Torch-convention NCHW/OIHW layouts so torch state dicts map 1:1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from of_spmm import nn

# VGG16 configuration "D": conv channel per stage, 'M' = 2x2 maxpool.
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")


@dataclasses.dataclass(frozen=True)
class VGG16:
    """VGG-16 (configuration D), plain conv+ReLU, three FC layers."""

    n_classes: int = 1000
    in_ch: int = 3
    dropout: float = 0.5

    def _convs(self):
        convs = []
        ch = self.in_ch
        for c in _VGG16_CFG:
            if c == "M":
                continue
            convs.append(nn.Conv2d(ch, c, 3, padding=1))
            ch = c
        return convs

    def _fcs(self):
        return [nn.Linear(512 * 7 * 7, 4096), nn.Linear(4096, 4096),
                nn.Linear(4096, self.n_classes)]

    def init(self, key):
        convs, fcs = self._convs(), self._fcs()
        keys = jax.random.split(key, len(convs) + len(fcs))
        p = {}
        for i, c in enumerate(convs):
            p[f"conv_{i}"] = c.init(keys[i])
        for i, f in enumerate(fcs):
            p[f"fc_{i}"] = f.init(keys[len(convs) + i])
        return p

    def apply(self, params, x, *, train=False, rng=None):
        convs = self._convs()
        pool = nn.MaxPool2d(2, stride=2)
        ci = 0
        h = x
        for c in _VGG16_CFG:
            if c == "M":
                h = pool.apply({}, h)
            else:
                h = jax.nn.relu(convs[ci].apply(params[f"conv_{ci}"], h))
                ci += 1
        h = h.reshape(h.shape[0], -1)
        drop = nn.Dropout(self.dropout)
        fcs = self._fcs()
        for i in range(2):
            h = jax.nn.relu(fcs[i].apply(params[f"fc_{i}"], h))
            if train and rng is not None:
                rng, sub = jax.random.split(rng)
                h = drop.apply({}, h, train=True, rng=sub)
        return fcs[2].apply(params["fc_2"], h)


@dataclasses.dataclass(frozen=True)
class AlexNet:
    """AlexNet (single-tower torchvision variant)."""

    n_classes: int = 1000
    in_ch: int = 3
    dropout: float = 0.5

    def _convs(self):
        return [
            nn.Conv2d(self.in_ch, 64, 11, stride=4, padding=2),
            nn.Conv2d(64, 192, 5, padding=2),
            nn.Conv2d(192, 384, 3, padding=1),
            nn.Conv2d(384, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
        ]

    def _fcs(self):
        return [nn.Linear(256 * 6 * 6, 4096), nn.Linear(4096, 4096),
                nn.Linear(4096, self.n_classes)]

    def init(self, key):
        convs, fcs = self._convs(), self._fcs()
        keys = jax.random.split(key, len(convs) + len(fcs))
        p = {}
        for i, c in enumerate(convs):
            p[f"conv_{i}"] = c.init(keys[i])
        for i, f in enumerate(fcs):
            p[f"fc_{i}"] = f.init(keys[len(convs) + i])
        return p

    def apply(self, params, x, *, train=False, rng=None):
        convs = self._convs()
        pool = nn.MaxPool2d(3, stride=2)
        h = x
        for i, c in enumerate(convs):
            h = jax.nn.relu(c.apply(params[f"conv_{i}"], h))
            if i in (0, 1, 4):
                h = pool.apply({}, h)
        # torchvision adaptive-pools to 6x6; with 224 input this is identity
        h = nn.AdaptiveAvgPool2d(6).apply({}, h)
        h = h.reshape(h.shape[0], -1)
        drop = nn.Dropout(self.dropout)
        fcs = self._fcs()
        for i in range(2):
            if train and rng is not None:
                rng, sub = jax.random.split(rng)
                h = drop.apply({}, h, train=True, rng=sub)
            h = jax.nn.relu(fcs[i].apply(params[f"fc_{i}"], h))
        return fcs[2].apply(params["fc_2"], h)


def vgg16(n_classes: int = 1000) -> VGG16:
    return VGG16(n_classes=n_classes)


def alexnet(n_classes: int = 1000) -> AlexNet:
    return AlexNet(n_classes=n_classes)
