"""The plain reference against the port's eager CPU path at a tiny size, in
f32 (the port is held to the JAX package by tests/)."""

import numpy as np
import pytest
import torch

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import make_preprocess_fn
from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
from nasa_niswan_tpu_torch.train.loop import build_train_step_fn, make_optimizer
from niswan_bench.lib import data, port
from niswan_bench.reference import convlstm as ref
from niswan_bench.reference.feed import batch_order
from niswan_bench.tests import tiny
from nasa_niswan_tpu_torch.data.pipeline import batch_indices


def f32(cfg):
    return dict(cfg, compute_dtype="float32")


@pytest.mark.parametrize("shape,padded", [((3, 10, 16), (12, 20)), ((2, 90, 144), (100, 154)),
                                          ((1, 9, 13), (12, 18))])
def test_pad_and_crop_equal_the_port(shape, padded):
    x = torch.randn(shape, dtype=torch.float64)
    assert torch.equal(ref.pad_grid(x, padded), pad_geo(x, padded))
    y = pad_geo(x, padded)
    assert torch.equal(ref.crop_grid(y, shape[1:]), crop_to_grid(y, shape[1:]))


def test_static_maps_zscored_as_the_port_does():
    static = data.static_fields(data.generator(3, "cpu"), 3, (10, 16))
    pre = make_preprocess_fn(port.normalizer({"x_mean": np.zeros(2, np.float32),
                                              "x_std": np.ones(2, np.float32),
                                              "y_mean": 0.0, "y_std": 1.0}),
                             None, static=static)
    x, _ = pre(torch.zeros(1, 2, 10, 16), torch.zeros(1, 10, 16))
    np.testing.assert_allclose(x[0, ..., 2:].permute(2, 0, 1).numpy(), ref.zscore_maps(static),
                               atol=1e-5)


def test_rollout_equals_the_port():
    cfg = f32(tiny.config("convlstm_l20_62c"))
    gen = data.generator(5, "cpu")
    params = data.convlstm_params(gen, cfg, "cpu")
    stats = data.normalizer_stats(gen, cfg["in_channels"])
    x = data.frames(gen, (1, 7, cfg["in_channels"], *cfg["grid"]), stats)
    rollout = make_rollout_fn(port.convlstm_config(cfg), port.normalizer(stats),
                              padded_shape=tuple(cfg["padded"]), grid_shape=tuple(cfg["grid"]))
    model = ref.Model(params, cfg, stats)
    p_port, s_port = rollout(params, x[:, :4])
    p_port2, s_port2 = rollout(params, x[:, 4:], s_port)
    p_ref, s_ref = model.rollout(x[:, :4])
    p_ref2, s_ref2 = model.rollout(x[:, 4:], s_ref)
    torch.testing.assert_close(torch.cat([p_port, p_port2], 1), torch.cat([p_ref, p_ref2], 1),
                               rtol=1e-5, atol=1e-5)
    for (h, c), (hr, cr) in zip(s_port2, s_ref2):
        torch.testing.assert_close(h, ref.to_nhwc(hr), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c, ref.to_nhwc(cr), rtol=1e-5, atol=1e-5)


def test_training_step_equals_the_port():
    cfg = f32(tiny.config("convlstm_surface_8c"))
    gen = data.generator(9, "cpu")
    params = data.convlstm_params(gen, cfg, "cpu", trainable=True)
    stats = data.normalizer_stats(gen, cfg["dynamic_channels"])
    static = data.static_fields(gen, cfg["in_channels"] - cfg["dynamic_channels"], cfg["grid"])
    x = data.frames(gen, (2, 4, cfg["dynamic_channels"], *cfg["grid"]), stats)
    y = data.targets(gen, 2, cfg["grid"], stats)
    leaves = [t.detach().clone().requires_grad_(True) for t in data.tree_leaves(params)]
    ref_params = {"cells": [dict(zip(("w_x", "w_h", "b"), leaves[3 * i:3 * i + 3]))
                            for i in range(3)], "head": {"w": leaves[-2], "b": leaves[-1]}}

    model = build_model(cfg["model_name"], in_channels=cfg["in_channels"],
                        hidden_channels=tuple(cfg["hidden_channels"]),
                        kernel_sizes=tuple(cfg["kernel_sizes"]), compute_dtype="float32")
    opt = make_optimizer(params, cfg["learning_rate"], tuple(cfg["betas"]))
    step = build_train_step_fn(model, port.normalizer(stats), opt,
                               padded_shape=tuple(cfg["padded"]),
                               grid_shape=tuple(cfg["grid"]), static=static)
    trainer = ref.Trainer(ref.Model(ref_params, cfg, stats, static), cfg["learning_rate"],
                          cfg["betas"])
    for _ in range(2):
        _, metrics = step(params, None, x, y)
        loss = trainer.step(x, y)
        assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
        for a, b in zip(data.tree_leaves(params), trainer.leaves):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-7)
    # Adam divides each gradient by its own size, so an element whose
    # gradient is nought to rounding may move by a different share of lr
    for a, b in zip(data.tree_leaves(params), trainer.leaves):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0.02 * cfg["learning_rate"])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345])
def test_batch_order_equals_the_port(seed):
    for epoch in (1, 2):
        want = list(batch_indices(103, 8, seed=seed % 2 ** 32, epoch=epoch))
        got = batch_order(103, 8, seed, epoch)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, dtype=torch.float32)
    err8 = (ref.round_to(x, "fp8") - x).abs().mean()
    err16 = (x.bfloat16().float() - x).abs().mean()
    assert err8 > 8 * err16
    assert torch.equal(ref.round_to(x, "f32"), x)
