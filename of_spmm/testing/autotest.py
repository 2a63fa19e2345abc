"""Dual-object autotest: run the same module against torch, compare everything.

The reference's workhorse test strategy wraps torch and oneflow behind one
proxy object and executes each test body against both frameworks, comparing
outputs AND gradients at rtol=1e-4/atol=1e-5
(python/oneflow/test_utils/automated_test_util/torch_flow_dual_object.py:726,
1044, 1374). This is the same idea re-expressed for a functional framework:

- ``torch_equivalent(module, params)`` builds the torch twin of one of our
  modules with weights copied (layouts are torch-convention by design, so
  most transforms are identity; Linear transposes).
- ``check_module_against_torch`` runs forward on shared random inputs and
  compares outputs, input-gradients, and parameter-gradients against torch's
  autograd — the gather<->segment-sum pairing and every custom_vjp in the
  stack is thereby validated against an independent autograd engine.
- ``@autotest(n=...)`` repeats a test body over n random seeds (the
  randomized-shapes loop of the reference's @autotest decorator).

torch is used ONLY inside tests as an oracle; the framework itself never
imports it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Reference parity bar (torch_flow_dual_object.py check_equality defaults).
RTOL = 1e-4
ATOL = 1e-5


def assert_close(a, b, rtol: float = RTOL, atol: float = ATOL, what: str = ""):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def autotest(n: int = 3, seed: int = 0) -> Callable:
    """Repeat a test body over ``n`` PRNG keys: body(key, trial_index)."""

    def deco(fn):
        def wrapper():
            keys = jax.random.split(jax.random.key(seed), n)
            for i in range(n):
                fn(key=keys[i], trial=i)

        # plain zero-arg function so pytest doesn't look for fixtures
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# our-module -> torch-module converters
# ---------------------------------------------------------------------------
# Each converter returns (torch_module, mapping) where mapping is a list of
# (our_param_path, torch_parameter, to_torch_layout) triples. to_torch_layout
# is linear (transpose/reshape), so the SAME function maps our param grads
# into torch layout for comparison.

_CONVERTERS: Dict[type, Callable] = {}


def _register(cls):
    def deco(fn):
        _CONVERTERS[cls] = fn
        return fn

    return deco


def _t(x) -> "Any":
    import torch

    return torch.from_numpy(np.asarray(x).copy())


def _ident(x):
    return np.asarray(x)


def _load(mapping):
    import torch

    with torch.no_grad():
        for _, tparam, our_val in mapping:
            tparam.copy_(_t(our_val))


def torch_equivalent(module, params) -> Tuple[Any, list]:
    """Build the torch twin of ``module`` with ``params`` copied in."""
    conv = _CONVERTERS.get(type(module))
    if conv is None:
        raise NotImplementedError(
            f"no torch converter registered for {type(module).__name__}"
        )
    return conv(module, params)


def _converter(cls):
    return _register(cls)


from of_spmm import nn as _nn  # noqa: E402


@_converter(_nn.Linear)
def _linear(m, p):
    import torch

    tm = torch.nn.Linear(m.in_features, m.out_features, bias=m.use_bias)
    mapping = [("w", tm.weight, np.asarray(p["w"]).T)]
    if m.use_bias:
        mapping.append(("b", tm.bias, np.asarray(p["b"])))
    _load(mapping)
    return tm, mapping


@_converter(_nn.Conv2d)
def _conv2d(m, p):
    import torch

    tm = torch.nn.Conv2d(
        m.in_channels, m.out_channels, m.kernel_size, stride=m.stride,
        padding=m.padding, dilation=m.dilation, groups=m.groups,
        bias=m.use_bias,
    )
    mapping = [("w", tm.weight, np.asarray(p["w"]))]
    if m.use_bias:
        mapping.append(("b", tm.bias, np.asarray(p["b"])))
    _load(mapping)
    return tm, mapping


@_converter(_nn.Conv1d)
def _conv1d(m, p):
    import torch

    tm = torch.nn.Conv1d(
        m.in_channels, m.out_channels, m.kernel_size, stride=m.stride,
        padding=m.padding, dilation=m.dilation, groups=m.groups,
        bias=m.use_bias,
    )
    mapping = [("w", tm.weight, np.asarray(p["w"]))]
    if m.use_bias:
        mapping.append(("b", tm.bias, np.asarray(p["b"])))
    _load(mapping)
    return tm, mapping


@_converter(_nn.LayerNorm)
def _layernorm(m, p):
    import torch

    tm = torch.nn.LayerNorm(
        m.normalized_shape, eps=m.eps, elementwise_affine=m.elementwise_affine
    )
    mapping = []
    if m.elementwise_affine:
        mapping = [
            ("gamma", tm.weight, np.asarray(p["gamma"])),
            ("beta", tm.bias, np.asarray(p["beta"])),
        ]
        _load(mapping)
    return tm, mapping


@_converter(_nn.BatchNorm)
def _batchnorm(m, p):
    import torch

    tm = torch.nn.BatchNorm1d(m.num_features, eps=m.eps, momentum=m.momentum,
                              affine=m.affine)
    mapping = []
    if m.affine:
        mapping = [
            ("gamma", tm.weight, np.asarray(p["gamma"])),
            ("beta", tm.bias, np.asarray(p["beta"])),
        ]
        _load(mapping)
    return tm, mapping


@_converter(_nn.Embedding)
def _embedding(m, p):
    import torch

    tm = torch.nn.Embedding(m.num_embeddings, m.embedding_dim,
                            padding_idx=m.padding_idx)
    mapping = [("weight", tm.weight, np.asarray(p["weight"]))]
    _load(mapping)
    return tm, mapping


@_converter(_nn.LSTM)
def _lstm(m, p):
    import torch

    tm = torch.nn.LSTM(m.input_size, m.hidden_size)
    mapping = [
        ("w_ih", tm.weight_ih_l0, np.asarray(p["w_ih"])),
        ("w_hh", tm.weight_hh_l0, np.asarray(p["w_hh"])),
        ("b_ih", tm.bias_ih_l0, np.asarray(p["b_ih"])),
        ("b_hh", tm.bias_hh_l0, np.asarray(p["b_hh"])),
    ]
    _load(mapping)
    return tm, mapping


@_converter(_nn.GRU)
def _gru(m, p):
    import torch

    tm = torch.nn.GRU(m.input_size, m.hidden_size)
    mapping = [
        ("w_ih", tm.weight_ih_l0, np.asarray(p["w_ih"])),
        ("w_hh", tm.weight_hh_l0, np.asarray(p["w_hh"])),
        ("b_ih", tm.bias_ih_l0, np.asarray(p["b_ih"])),
        ("b_hh", tm.bias_hh_l0, np.asarray(p["b_hh"])),
    ]
    _load(mapping)
    return tm, mapping


@_converter(_nn.RNN)
def _rnn(m, p):
    import torch

    tm = torch.nn.RNN(m.input_size, m.hidden_size, nonlinearity=m.nonlinearity)
    mapping = [
        ("w_ih", tm.weight_ih_l0, np.asarray(p["w_ih"])),
        ("w_hh", tm.weight_hh_l0, np.asarray(p["w_hh"])),
        ("b_ih", tm.bias_ih_l0, np.asarray(p["b_ih"])),
        ("b_hh", tm.bias_hh_l0, np.asarray(p["b_hh"])),
    ]
    _load(mapping)
    return tm, mapping


@_converter(_nn.MultiheadAttention)
def _mha(m, p):
    import torch

    tm = torch.nn.MultiheadAttention(
        m.embed_dim, m.num_heads, bias=m.use_bias, batch_first=True
    )
    mapping = [
        ("in_w", tm.in_proj_weight, np.asarray(p["in_w"])),
        ("out_w", tm.out_proj.weight, np.asarray(p["out_w"])),
    ]
    if m.use_bias:
        mapping += [
            ("in_b", tm.in_proj_bias, np.asarray(p["in_b"])),
            ("out_b", tm.out_proj.bias, np.asarray(p["out_b"])),
        ]
    _load(mapping)
    return tm, mapping


@_converter(_nn.MaxPool2d)
def _maxpool(m, p):
    import torch

    return torch.nn.MaxPool2d(m.kernel_size, stride=m.stride,
                              padding=m.padding), []


@_converter(_nn.AvgPool2d)
def _avgpool(m, p):
    import torch

    return torch.nn.AvgPool2d(m.kernel_size, stride=m.stride,
                              padding=m.padding), []


# ---------------------------------------------------------------------------
# comparison engine
# ---------------------------------------------------------------------------


def _torch_forward(tm, tinputs, module):
    """Call the torch twin; unify multi-output conventions."""
    import torch

    if isinstance(tm, (torch.nn.LSTM, torch.nn.GRU, torch.nn.RNN)):
        y, _ = tm(*tinputs)
        return y
    if isinstance(tm, torch.nn.MultiheadAttention):
        q = tinputs[0]
        y, _ = tm(q, q, q, need_weights=False)
        return y
    return tm(*tinputs)


def _ours_forward(module, params, inputs, train: bool):
    out = module.apply(params, *inputs, train=train)
    if isinstance(out, tuple):  # stateful modules return (y, new_state)
        out = out[0]
    return out


def check_module_against_torch(
    module,
    params,
    inputs: Sequence[jnp.ndarray],
    *,
    rtol: float = RTOL,
    atol: float = ATOL,
    grad: bool = True,
    train: bool = False,
    int_inputs: bool = False,
) -> None:
    """Forward (+ backward) parity of one module against its torch twin.

    Loss = sum(y * ct) for a shared random cotangent ct, so dL/dy = ct and
    every gradient path is exercised with non-uniform weights.
    """
    import torch

    tm, mapping = torch_equivalent(module, params)
    tm = tm.train(train).double() if False else tm.train(train)

    tinputs = []
    for x in inputs:
        t = _t(x)
        if not int_inputs:
            t = t.requires_grad_(True)
        tinputs.append(t)

    ty = _torch_forward(tm, tinputs, module)
    y = _ours_forward(module, params, inputs, train)
    assert_close(y, ty.detach().numpy(), rtol, atol, "forward")

    if not grad:
        return

    ct = np.random.default_rng(0).standard_normal(y.shape).astype(np.float32)

    # ours: gradients wrt (params, float inputs)
    def loss_ours(params, *xs):
        return jnp.sum(_ours_forward(module, params, xs, train) * ct)

    argnums = (0,) if int_inputs else tuple(range(len(inputs) + 1))
    grads = jax.grad(loss_ours, argnums=argnums)(params, *inputs)
    g_params = grads[0]
    g_inputs = () if int_inputs else grads[1:]

    # torch: same loss
    (ty * _t(ct)).sum().backward()

    if not int_inputs:
        for i, (gx, tx) in enumerate(zip(g_inputs, tinputs)):
            assert_close(gx, tx.grad.numpy(), rtol, atol, f"d/d input[{i}]")

    for path, tparam, our_layout in mapping:
        g = g_params[path]
        # map our grad into torch layout with the same linear transform the
        # weight itself used (transpose for Linear, identity elsewhere)
        if np.asarray(our_layout).shape != np.asarray(g).shape:
            g = np.asarray(g).T
        assert_close(g, tparam.grad.numpy(), rtol, atol, f"d/d {path}")


def check_grads_against_torch(
    fn_ours: Callable,
    fn_torch: Callable,
    inputs: Sequence[np.ndarray],
    *,
    rtol: float = RTOL,
    atol: float = ATOL,
) -> None:
    """Parity of a pure function (fwd + input grads) against a torch fn."""
    import torch

    tinputs = [_t(x).requires_grad_(x.dtype.kind == "f") for x in inputs]
    ty = fn_torch(*tinputs)
    y = fn_ours(*[jnp.asarray(x) for x in inputs])
    assert_close(y, ty.detach().numpy(), rtol, atol, "forward")

    ct = np.random.default_rng(0).standard_normal(np.asarray(y).shape)
    ct = ct.astype(np.asarray(y).dtype)

    float_idx = [i for i, x in enumerate(inputs) if x.dtype.kind == "f"]
    grads = jax.grad(
        lambda *xs: jnp.sum(fn_ours(*xs) * ct), argnums=tuple(float_idx)
    )(*[jnp.asarray(x) for x in inputs])
    (ty * _t(ct)).sum().backward()
    for gi, i in zip(grads, float_idx):
        assert_close(gi, tinputs[i].grad.numpy(), rtol, atol, f"d/d input[{i}]")
