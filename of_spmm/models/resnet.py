"""ResNet family (reference benchmark workloads: ResNet50 is the CI speed
gate, ci/test/test_speed_multi_client.sh:29-43; model definitions live in
the oneflow model zoo consumed by those scripts).

Torch-convention NCHW/OIHW so torch state dicts map 1:1; BasicBlock for
18/34, Bottleneck for 50/101/152. BatchNorm is the stateful module from
nn/layers.py — apply(train=True) threads running stats."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from of_spmm import nn


def _conv_bn(key, in_ch, out_ch, k, stride=1, padding=0):
    conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding,
                     use_bias=False)
    bn = nn.BatchNorm(out_ch)
    kc, kb = jax.random.split(key)
    return (conv, bn), {"conv": conv.init(kc), "bn": bn.init(kb)}


def _apply_conv_bn(mods, params, state, x, train):
    conv, bn = mods
    y = conv.apply(params["conv"], x)
    # BatchNorm over channel axis: move C last, normalize, move back
    y = jnp.moveaxis(y, 1, -1)
    if train:
        y, new_state = bn.apply(params["bn"], y, state=state, train=True)
    else:
        y = bn.apply(params["bn"], y, state=state, train=False)
        new_state = state
    return jnp.moveaxis(y, -1, 1), new_state


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """1x1 -> 3x3 -> 1x1 with residual (ResNet50-style, expansion 4)."""

    in_ch: int
    mid_ch: int
    stride: int = 1

    @property
    def out_ch(self) -> int:
        return 4 * self.mid_ch

    def _mods(self):
        c1 = nn.Conv2d(self.in_ch, self.mid_ch, 1, use_bias=False)
        c2 = nn.Conv2d(self.mid_ch, self.mid_ch, 3, stride=self.stride,
                       padding=1, use_bias=False)
        c3 = nn.Conv2d(self.mid_ch, self.out_ch, 1, use_bias=False)
        bns = [nn.BatchNorm(self.mid_ch), nn.BatchNorm(self.mid_ch),
               nn.BatchNorm(self.out_ch)]
        down = None
        if self.stride != 1 or self.in_ch != self.out_ch:
            down = (nn.Conv2d(self.in_ch, self.out_ch, 1, stride=self.stride,
                              use_bias=False), nn.BatchNorm(self.out_ch))
        return (c1, c2, c3), bns, down

    def init(self, key):
        convs, bns, down = self._mods()
        keys = jax.random.split(key, 8)
        p = {}
        for i, (c, b) in enumerate(zip(convs, bns)):
            p[f"conv{i}"] = c.init(keys[2 * i])
            p[f"bn{i}"] = b.init(keys[2 * i + 1])
        if down is not None:
            p["down_conv"] = down[0].init(keys[6])
            p["down_bn"] = down[1].init(keys[7])
        return p

    def init_state(self):
        _, bns, down = self._mods()
        s = {f"bn{i}": b.init_state() for i, b in enumerate(bns)}
        if down is not None:
            s["down_bn"] = down[1].init_state()
        return s

    def apply(self, params, x, *, state=None, train=False, rng=None):
        convs, bns, down = self._mods()
        if state is None:
            state = self.init_state()
        new_state = dict(state)
        h = x
        for i, (c, b) in enumerate(zip(convs, bns)):
            h = c.apply(params[f"conv{i}"], h)
            hh = jnp.moveaxis(h, 1, -1)
            if train:
                hh, new_state[f"bn{i}"] = b.apply(
                    params[f"bn{i}"], hh, state=state[f"bn{i}"], train=True)
            else:
                hh = b.apply(params[f"bn{i}"], hh, state=state[f"bn{i}"],
                             train=False)
            h = jnp.moveaxis(hh, -1, 1)
            if i < 2:
                h = jax.nn.relu(h)
        shortcut = x
        if down is not None:
            shortcut = down[0].apply(params["down_conv"], x)
            sc = jnp.moveaxis(shortcut, 1, -1)
            if train:
                sc, new_state["down_bn"] = down[1].apply(
                    params["down_bn"], sc, state=state["down_bn"], train=True)
            else:
                sc = down[1].apply(params["down_bn"], sc,
                                   state=state["down_bn"], train=False)
            shortcut = jnp.moveaxis(sc, -1, 1)
        out = jax.nn.relu(h + shortcut)
        if train:
            return out, new_state
        return out


@dataclasses.dataclass(frozen=True)
class ResNet:
    """ResNet-{50,101,152} via Bottleneck stages (the CI-gate model)."""

    layers: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet50
    n_classes: int = 1000
    in_ch: int = 3
    width: int = 64

    def _blocks(self):
        blocks = []
        in_ch = self.width
        mid = self.width
        for si, n in enumerate(self.layers):
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(in_ch, mid, stride))
                in_ch = 4 * mid
            mid *= 2
        return blocks

    def init(self, key):
        blocks = self._blocks()
        keys = jax.random.split(key, len(blocks) + 3)
        stem_conv = nn.Conv2d(self.in_ch, self.width, 7, stride=2, padding=3,
                              use_bias=False)
        stem_bn = nn.BatchNorm(self.width)
        head = nn.Linear(blocks[-1].out_ch, self.n_classes)
        p = {
            "stem_conv": stem_conv.init(keys[0]),
            "stem_bn": stem_bn.init(keys[1]),
            "head": head.init(keys[2]),
        }
        for i, b in enumerate(blocks):
            p[f"block_{i}"] = b.init(keys[3 + i])
        return p

    def init_state(self):
        s = {"stem_bn": nn.BatchNorm(self.width).init_state()}
        for i, b in enumerate(self._blocks()):
            s[f"block_{i}"] = b.init_state()
        return s

    def apply(self, params, x, *, state=None, train=False, rng=None):
        blocks = self._blocks()
        if state is None:
            state = self.init_state()
        new_state = dict(state)
        stem_conv = nn.Conv2d(self.in_ch, self.width, 7, stride=2, padding=3,
                              use_bias=False)
        stem_bn = nn.BatchNorm(self.width)
        h = stem_conv.apply(params["stem_conv"], x)
        hh = jnp.moveaxis(h, 1, -1)
        if train:
            hh, new_state["stem_bn"] = stem_bn.apply(
                params["stem_bn"], hh, state=state["stem_bn"], train=True)
        else:
            hh = stem_bn.apply(params["stem_bn"], hh, state=state["stem_bn"],
                               train=False)
        h = jax.nn.relu(jnp.moveaxis(hh, -1, 1))
        h = nn.MaxPool2d(3, stride=2, padding=1).apply({}, h)
        for i, b in enumerate(blocks):
            if train:
                h, new_state[f"block_{i}"] = b.apply(
                    params[f"block_{i}"], h, state=state[f"block_{i}"],
                    train=True)
            else:
                h = b.apply(params[f"block_{i}"], h,
                            state=state[f"block_{i}"], train=False)
        h = jnp.mean(h, axis=(2, 3))  # global average pool
        logits = nn.Linear(blocks[-1].out_ch, self.n_classes).apply(
            params["head"], h)
        if train:
            return logits, new_state
        return logits


def resnet50(n_classes: int = 1000) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), n_classes=n_classes)


def resnet101(n_classes: int = 1000) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), n_classes=n_classes)
