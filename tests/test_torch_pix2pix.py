"""The port's pix2pix Generator and PatchGAN Discriminator against the JAX
package: the init trees (names, flatten order, shapes), both networks'
outputs and the generator's gradients on shared weights with dropout off,
the dropout masks drawn where JAX draws them, and one epoch of ``fit`` on
a PIX2PIX model against JAX's, dropout on through one fixed mask per
dropout call (a pytest ``monkeypatch`` replaces ``dropout2d`` in both
packages' pix2pix modules; the JAX package is not changed).

Shapes: generator features 4 at 256 x 256 (the smallest map its eight
stride-2 stages take without an empty bottleneck), discriminator features
(4, 8, 16, 32).  Tolerances: outputs and per-leaf gradients within 1e-4 of
their largest magnitude (f32 sums in other orders through 16 layers); the
epoch's loss rtol 1e-4 and validation R^2 atol 1e-4."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import SingleStepDataset as JSingleStep  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as j_synthetic  # noqa: E402
from nasa_niswan_tpu.models import pix2pix as jm  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import SingleStepDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models import pix2pix as tm  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402

TOL = 1e-4
D_FEATS = (4, 8, 16, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def fixed_masks(n_calls: int, shape, seed: int):
    """``dropout2d`` stand-ins for both packages: call i (modulo n_calls)
    multiplies by the i-th fixed Dropout2d(0.5) mask, (B, 1, 1, C) of 0 or 2.
    JAX traces a jitted step once, so its calls are the first n_calls; the
    port calls it again every forward."""
    rng = np.random.default_rng(seed)
    masks = [(rng.random(shape) < 0.5).astype(np.float32) * 2.0 for _ in range(n_calls)]
    calls = {"jax": 0, "torch": 0}

    def j_drop(x, rate, rng, *, training):
        assert training and rate == 0.5 and rng is not None
        m = masks[calls["jax"] % n_calls]
        calls["jax"] += 1
        return x * m

    def t_drop(x, rate, generator, *, training):
        assert training and rate == 0.5 and generator is not None
        m = masks[calls["torch"] % n_calls]
        calls["torch"] += 1
        return x * torch.from_numpy(m).to(x.device)

    return j_drop, t_drop, calls


def patch_dropout(monkeypatch, n_calls, shape, seed=0):
    j_drop, t_drop, calls = fixed_masks(n_calls, shape, seed)
    monkeypatch.setattr(jm, "dropout2d", j_drop)
    monkeypatch.setattr(tm, "dropout2d", t_drop)
    return calls


def _trainable(tree):
    for t in bridge.tree_leaves(tree):
        t.requires_grad_(True)
    return tree


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_init_trees_match_jax(which):
    if which == "generator":
        jcfg, tcfg = jm.GeneratorConfig(), tm.GeneratorConfig()
        jtree = jax.eval_shape(partial(jm.generator_init, config=jcfg), jax.random.PRNGKey(0))
        ttree = tm.generator_init(torch.Generator().manual_seed(0), tcfg)
    else:
        jcfg, tcfg = jm.DiscriminatorConfig(), tm.DiscriminatorConfig()
        jtree = jax.eval_shape(partial(jm.discriminator_init, config=jcfg),
                               jax.random.PRNGKey(0))
        ttree = tm.discriminator_init(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(jtree) == jax.tree.structure(bridge.params_to_jax(ttree))
    assert [a.shape for a in jax.tree.leaves(jtree)] == [
        tuple(t.shape) for t in bridge.tree_leaves(ttree)]
    w = ttree["enc3" if which == "generator" else "block3"]["w"]
    assert abs(w.std().item() - 0.02) < 2e-3  # N(0, 0.02) weights


@pytest.fixture(scope="module")
def gen_pair():
    cfg = tm.GeneratorConfig(in_channels=2, features=4)
    params = _trainable(tm.generator_init(torch.Generator().manual_seed(1), cfg))
    return cfg, params, bridge.params_to_jax(params)


def test_generator_matches_jax(gen_pair):
    """Output and per-leaf gradients of the L1 loss, dropout off."""
    _, params, jp = gen_pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 256, 256, 2)).astype(np.float32)
    y = rng.standard_normal((2, 256, 256, 1)).astype(np.float32)

    def j_loss(p):
        out = jm.generator_apply(p, x)
        return jnp.mean(jnp.abs(y - out)), out

    (_, want), want_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)
    out = tm.generator_apply(params, torch.from_numpy(x))
    _close(out.detach(), want)
    grads = torch.autograd.grad(torch.mean(torch.abs(torch.from_numpy(y) - out)),
                                bridge.tree_leaves(params))
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        _close(g, w)


def test_discriminator_matches_jax():
    cfg = tm.DiscriminatorConfig(in_channels=1, features=D_FEATS)
    params = tm.discriminator_init(torch.Generator().manual_seed(3), cfg)
    jp = bridge.params_to_jax(params)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    y = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    want = jm.discriminator_apply(jp, x, y, jm.DiscriminatorConfig(1, D_FEATS))
    got = tm.discriminator_apply(params, torch.from_numpy(x), torch.from_numpy(y), cfg)
    assert got.shape == (2, 6, 6, 1)  # 64 -> 32 -> 16 -> 8 -> 7 (stride 1) -> 6
    _close(got, want)


def test_generator_dropout_masks_where_jax_draws_them(gen_pair, monkeypatch):
    """Training with a generator draws one mask on each of decoder blocks
    1-3, as JAX does with a key; with the same masks the outputs agree.
    Without a generator, or in eval mode, no dropout runs."""
    _, params, jp = gen_pair
    calls = patch_dropout(monkeypatch, 3, (2, 1, 1, 32))
    x = np.random.default_rng(5).standard_normal((2, 256, 256, 2)).astype(np.float32)
    want = jax.jit(partial(jm.generator_apply, training=True))(
        jp, x, dropout_rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        got = tm.generator_apply(params, torch.from_numpy(x), training=True,
                                 generator=torch.Generator().manual_seed(0))
        assert calls == {"jax": 3, "torch": 3}
        _close(got, want)
        tm.generator_apply(params, torch.from_numpy(x), training=True)
        tm.generator_apply(params, torch.from_numpy(x),
                           generator=torch.Generator().manual_seed(0))
    assert calls["torch"] == 3


def test_generator_dropout_draws_from_the_generator(gen_pair):
    _, params, _ = gen_pair
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal((2, 256, 256, 2)).astype(np.float32))
    with torch.no_grad():
        a, b, c = (tm.generator_apply(params, x, training=True,
                                      generator=torch.Generator().manual_seed(s))
                   for s in (7, 7, 8))
        off = tm.generator_apply(params, x, training=True)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)


def test_fit_pix2pix_matches_jax_first_epoch(tmp_path, monkeypatch):
    """One epoch of ``fit`` on a PIX2PIX generator (features 4, 90 x 144
    padded to 256 x 256, 4 steps of bs 4) from the same weights, dropout on
    through fixed masks, against JAX's."""
    patch_dropout(monkeypatch, 3, (4, 1, 1, 32), seed=9)
    kw = dict(model="PIX2PIX-f", in_channels=5, pix2pix_features=4,
              input_size=(256, 256), batch_size=4, num_epochs=1, checkpoint_every=0)
    tds = [SingleStepDataset(synthetic_e33oma_90d(T=24, seed=3), period=p)
           for p in ("train", "val")]
    jds = [JSingleStep(j_synthetic(T=24, seed=3), period=p) for p in ("train", "val")]
    bundle = build_model("PIX2PIX-f", in_channels=5, pix2pix_features=4)
    params, _ = bundle.init(torch.Generator().manual_seed(3), "cpu")
    jbundle = j_build_model("PIX2PIX-f", in_channels=5, pix2pix_features=4)
    jout = jloop.fit(jbundle, *jds, JTrainConfig(snapshot_dir=str(tmp_path / "j"), **kw),
                     init_params=bridge.params_to_jax(params), verbose=False)
    tout = tloop.fit(bundle, *tds, TrainConfig(snapshot_dir=str(tmp_path / "t"),
                                               device="cpu", **kw),
                     device="cpu", init_params=params, verbose=False)
    np.testing.assert_allclose(tout["logger"]["MSELoss"], jout["logger"]["MSELoss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tout["logger"]["r2_score_val"],
                               jout["logger"]["r2_score_val"], rtol=0, atol=1e-4)
    assert tout["state"] is None
