"""The CUDA fused ConvLSTM cell against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; every test here skips without a CUDA device.
On a machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which the port
does not need.)  This file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import (  # noqa: E402
    ConvLSTMConfig,
    convlstm_init,
)
from nasa_niswan_tpu_torch.ops import convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    fused_cell_forward,
    fused_cell_forward_plain,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cell_inputs(device, dtype, B, H, W, cin, hid, k, seed=0):
    rng = np.random.default_rng(seed)
    xh = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((B, H, W, hid)), dtype=torch.float32)
    w = torch.tensor(
        rng.standard_normal((k, k, cin, 4 * hid)) / np.sqrt(k * k * cin),
        dtype=torch.float32,
    )
    b = torch.tensor(0.1 * rng.standard_normal(4 * hid), dtype=torch.float32)
    return xh.to(device, dtype), c.to(device), w.to(device, dtype), b.to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,H,W,cin,hid,k",
    [
        (1, 16, 24, 9, 8, 3),
        (2, 20, 28, 13, 16, 5),
        (1, 10, 12, 5, 4, 1),
        (1, 9, 37, 70, 64, 7),  # two channel chunks, ragged rows and columns
    ],
)
def test_kernel_matches_plain(device, dtype, B, H, W, cin, hid, k):
    """f32 sums in another order: tolerance 1e-3, and reruns bit-identical."""
    args = _cell_inputs(device, dtype, B, H, W, cin, hid, k)
    before = convlstm_cell.launches
    h1, c1 = fused_cell_forward(*args)
    h1b, c1b = fused_cell_forward(*args)
    h2, c2 = fused_cell_forward_plain(*args)
    torch.cuda.synchronize()
    assert convlstm_cell.launches == before + 2
    assert torch.equal(h1, h1b) and torch.equal(c1, c1b)
    assert (h1 - h2).abs().max().item() <= 1e-3
    assert (c1 - c2).abs().max().item() <= 1e-3


def test_kernel_rejects_bad_args(device):
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, 1, 8, 8, 4, 4, 3)
    with pytest.raises(ValueError):
        fused_cell_forward(xh.transpose(1, 2), c, w, b)
    with pytest.raises(TypeError):
        fused_cell_forward(xh, c, w.float(), b)


def test_rollout_kernel_matches_plain(device):
    cfg = ConvLSTMConfig(
        in_channels=8, hidden_channels=(8, 4, 4), kernel_sizes=(5, 3, 3)
    )
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    norm = Normalizer(np.zeros(8, np.float32), np.ones(8, np.float32), 0.5, 2.0)
    forcings = np.random.default_rng(1).standard_normal((2, 6, 8, 16, 24))
    kw = dict(padded_shape=(20, 28), grid_shape=(16, 24), device=device)
    before = convlstm_cell.launches
    p1, s1 = make_rollout_fn(cfg, norm, **kw)(params, forcings.astype(np.float32))
    assert convlstm_cell.launches == before + 3 * 6
    p2, s2 = make_rollout_fn(cfg, norm, cell_fn=fused_cell_forward_plain, **kw)(
        params, forcings.astype(np.float32)
    )
    assert (p1 - p2).abs().max().item() <= 1e-4
    for (h1, c1), (h2, c2) in zip(s1, s2):
        assert (h1 - h2).abs().max().item() <= 1e-4
        assert (c1 - c2).abs().max().item() <= 1e-4
