"""The port's adversarial pix2pix step (``train/gan.py``) against the JAX
package: ``bce_with_logits``, and one ``make_gan_train_step`` from the same
weights and inputs on the same dropout masks (a pytest ``monkeypatch``
replaces ``dropout2d`` in both packages' pix2pix modules with one fixed
mask per call, six per step: the discriminator's generator forward, then
the generator's own).  The parity step updates with plain SGD on both
sides, so each parameter's move is its gradient: the discriminator's and
then, through the updated discriminator, the generator's.  A step with the
training Adams moves both networks.

Shapes: generator features 4 and discriminator features (4, 8, 16, 32) at
128 x 128, where the generator's bottleneck sees a 1 x 1 map (ops/conv.py
follows XLA's shapes there), batch 2.  Tolerances: losses rtol 1e-5, each
leaf's move within 1e-4 of its largest (f32 sums in other orders)."""

import jax
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models import pix2pix as jm  # noqa: E402
from nasa_niswan_tpu.train import gan as jgan  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.models import pix2pix as tm  # noqa: E402
from nasa_niswan_tpu_torch.train import gan as tgan  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import make_optimizer  # noqa: E402

from test_torch_pix2pix import patch_dropout  # noqa: E402

G_CFG = dict(in_channels=2, features=4)
D_CFG = dict(in_channels=1, features=(4, 8, 16, 32))
LR = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_bce_matches_jax():
    logits = np.random.default_rng(0).standard_normal(200).astype(np.float32) * 4
    for target in (0.0, 1.0):
        want = float(jgan.bce_with_logits(logits, target))
        got = tgan.bce_with_logits(torch.from_numpy(logits), target).item()
        assert abs(got - want) <= 1e-6 * abs(want)


def _nets(seed=0):
    g = tm.generator_init(torch.Generator().manual_seed(seed), tm.GeneratorConfig(**G_CFG))
    d = tm.discriminator_init(torch.Generator().manual_seed(seed + 1),
                              tm.DiscriminatorConfig(**D_CFG))
    for t in bridge.tree_leaves((g, d)):
        t.requires_grad_(True)
    return g, d


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 128, 128, 2)).astype(np.float32),
            rng.standard_normal((2, 128, 128, 1)).astype(np.float32))


def test_gan_step_matches_jax(monkeypatch):
    calls = patch_dropout(monkeypatch, 6, (2, 1, 1, 32), seed=3)
    g, d = _nets()
    jg, jd = bridge.params_to_jax(g), bridge.params_to_jax(d)
    x, y = _inputs()
    jstep = jgan.make_gan_train_step(jm.GeneratorConfig(**G_CFG),
                                     jm.DiscriminatorConfig(**D_CFG),
                                     optax.sgd(LR), optax.sgd(LR))
    sgd = optax.sgd(LR)
    jg2, jd2, _, _, jmet = jstep(jg, jd, sgd.init(jg), sgd.init(jd), x, y,
                                 jax.random.PRNGKey(0))
    tstep = tgan.make_gan_train_step(
        tm.GeneratorConfig(**G_CFG), tm.DiscriminatorConfig(**D_CFG),
        torch.optim.SGD(bridge.tree_leaves(g), lr=LR),
        torch.optim.SGD(bridge.tree_leaves(d), lr=LR))
    tmet = tstep(g, d, torch.from_numpy(x), torch.from_numpy(y),
                 torch.Generator().manual_seed(0))
    assert calls == {"jax": 6, "torch": 6}
    for k in ("g_loss", "d_loss", "l1"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-5)
    for before, after, jafter in ((jg, g, jg2), (jd, d, jd2)):
        for b, a, w in zip(jax.tree.leaves(before), bridge.tree_leaves(after),
                           jax.tree.leaves(jafter)):
            got, want = a.detach().numpy() - b, np.asarray(w) - b
            err = np.max(np.abs(got - want))
            assert err <= 1e-4 * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def test_gan_step_with_adam_moves_both_networks():
    g, d = _nets(4)
    g0, d0 = (bridge.params_to_jax(t) for t in (g, d))
    step = tgan.make_gan_train_step(
        tm.GeneratorConfig(**G_CFG), tm.DiscriminatorConfig(**D_CFG),
        make_optimizer(g, 2e-4, (0.5, 0.999)), make_optimizer(d, 2e-4, (0.5, 0.999)))
    x, y = (torch.from_numpy(a) for a in _inputs(5))
    metrics = step(g, d, x, y, torch.Generator().manual_seed(1))
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert not np.allclose(g["initial"]["w"].detach().numpy(), g0["initial"]["w"])
    assert not np.allclose(d["initial"]["w"].detach().numpy(), d0["initial"]["w"])
