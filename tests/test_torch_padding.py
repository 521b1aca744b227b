"""Geophysical padding and grid: the PyTorch port against the JAX package,
bit-exact on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.core import grid as jgrid  # noqa: E402
from nasa_niswan_tpu.core import padding as jpad  # noqa: E402
from nasa_niswan_tpu_torch.core import grid as tgrid  # noqa: E402
from nasa_niswan_tpu_torch.core import padding as tpad  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(fn_name, x, *args, **kwargs):
    want = np.asarray(getattr(jpad, fn_name)(x, *args, **kwargs))
    got = getattr(tpad, fn_name)(torch.from_numpy(x), *args, **kwargs).numpy()
    return want, got


@pytest.mark.parametrize(
    "shape,target",
    [((2, 3, 90, 144), 154), ((5, 7), 12), ((4, 6), 6), ((1, 2, 3, 8, 9), 17)],
)
def test_pad_cyclic_lon_matches_jax(shape, target):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want, got = _both("pad_cyclic_lon", x, target)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize(
    "shape,target",
    [((2, 3, 90, 144), 100), ((3, 4, 10, 6), 15), ((7, 5), 11), ((6, 4), 6)],
)
def test_pad_reflect_lat_matches_jax(shape, target, quirk):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, got = _both("pad_reflect_lat", x, target, quirk_channel_flip=quirk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pad_geo_and_crop_match_jax(quirk, dtype):
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 16, 24))
    x = (100 * x).astype(dtype)
    want, got = _both("pad_geo", x, (20, 28), quirk_channel_flip=quirk)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpad.crop_to_grid(torch.from_numpy(got), (16, 24)).numpy(),
        np.asarray(jpad.crop_to_grid(want, (16, 24))),
    )
    if not quirk:  # crop inverts the pad
        np.testing.assert_array_equal(
            tpad.crop_to_grid(torch.from_numpy(got), (16, 24)).numpy(), x
        )
    np.testing.assert_array_equal(
        tpad.crop_to_grid(torch.from_numpy(x), (10, 12), offsets=(3, 1)).numpy(),
        np.asarray(jpad.crop_to_grid(x, (10, 12), offsets=(3, 1))),
    )


def test_pad_bf16_is_a_copy_of_values():
    """Padding only moves values, so bf16 pads equal the f32 pads rounded."""
    x = np.random.default_rng(3).standard_normal((1, 3, 16, 24)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tpad.pad_geo(xt.bfloat16(), (20, 28)).float().numpy(),
        tpad.pad_geo(xt, (20, 28)).bfloat16().float().numpy(),
    )


@pytest.mark.parametrize(
    "fn,args",
    [
        ("pad_cyclic_lon", (4,)),  # target smaller than the axis
        ("pad_cyclic_lon", (30,)),  # pad wider than the axis
        ("pad_reflect_lat", (4,)),
        ("pad_reflect_lat", (20,)),  # pad reaches past the pole row
    ],
)
def test_pad_errors_match_jax(fn, args):
    x = np.zeros((6, 8), np.float32)
    with pytest.raises(ValueError):
        getattr(jpad, fn)(x, *args)
    with pytest.raises(ValueError):
        getattr(tpad, fn)(torch.from_numpy(x), *args)


def test_grid_spec_matches_jax():
    for name in ("MODELE_2x2P5", "MODELE_2x2P5_L20"):
        j, t = getattr(jgrid, name), getattr(tgrid, name)
        assert dataclasses_equal(j, t)
        np.testing.assert_array_equal(t.lat, j.lat)
        np.testing.assert_array_equal(t.lon, j.lon)
        np.testing.assert_array_equal(t.coslat_weights(), j.coslat_weights())
        assert t.crop_offsets((100, 154)) == j.crop_offsets((100, 154)) == (5, 5)
        assert t.padded_shape(5, 5) == j.padded_shape(5, 5) == (100, 154)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
