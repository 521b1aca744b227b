"""The work arithmetic against the port's recorded figures (PERF.md: 29.1
GFLOP a config #2 serving step, 21,255 GFLOP a surface training step, the
kernel table's least times)."""

import pytest

from niswan_bench.lib import spec, work

L20 = spec.config("convlstm_l20_62c")
SURFACE = spec.config("convlstm_surface_8c")


def ms(flops_bytes):
    return 1e3 * work.least_time_s(*flops_bytes)


def test_step_flops():
    assert work.serve_step_flops(L20) / 1e9 == pytest.approx(29.1, abs=0.05)
    assert work.train_step_flops(SURFACE, 8, 48) / 1e9 == pytest.approx(21255, abs=1)
    assert work.train_step_flops(L20, 8, 48) / 1e9 == pytest.approx(33500, abs=20)


@pytest.mark.parametrize("layer,want", [(0, 0.0251), (1, 0.0034), (2, 0.0013)])
def test_b1_serving_bounds(layer, want):
    k, cin, hid = work.layers(L20)[layer]
    assert ms(work.cell_fwd_work(work.pixels(L20), cin, hid, k)) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("layer,b1,b3", [(0, 0.1148, 0.1148), (1, 0.0276, 0.0276),
                                         (2, 0.0106, 0.0118)])
def test_training_bounds(layer, b1, b3):
    k, cin, hid = work.layers(SURFACE)[layer]
    px = 8 * work.pixels(SURFACE)
    assert ms(work.cell_fwd_work(px, cin, hid, k)) == pytest.approx(b1, abs=5e-5)
    assert ms(work.conv_same_work(px, 4 * hid, cin, k)) == pytest.approx(b3, abs=5e-5)


def test_b2_bound_of_the_three_layers():
    px = 8 * work.pixels(SURFACE)
    parts = [work.cell_bwd_work(px, cin, hid, k) for k, cin, hid in work.layers(SURFACE)]
    together = ms((sum(f for f, _ in parts), sum(b for _, b in parts)))
    assert together == pytest.approx(0.2985, abs=5e-5)


def test_step_bounds_add_the_launches():
    per_step = work.serve_b1_bound_s(L20)
    assert 1e3 * per_step == pytest.approx(0.0251 + 0.0034 + 0.0013, abs=2e-4)
    px = 8 * work.pixels(SURFACE)
    launches = sum(ms(work.cell_fwd_work(px, c, h, k)) + ms(work.cell_bwd_work(px, c, h, k))
                   + ms(work.conv_same_work(px, 4 * h, c, k))
                   for k, c, h in work.layers(SURFACE))
    assert 1e3 * work.train_cell_kernels_bound_s(SURFACE, 8, 48) == pytest.approx(48 * launches)
    assert 25 < 1e3 * work.train_cell_kernels_bound_s(SURFACE, 8, 48) < 35
