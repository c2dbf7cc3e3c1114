"""The ``"torch"`` analyzer lane on the card (``gpu``-marked; skipped
without one): at the fleet shape its seed rows stay within the lane's own
bound of float64, with the caller's TF32 switched on, and the caller's
setting survives the call.  This file imports no JAX: the reference is a
float64 evaluation of the same inputs."""
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro_torch.core import clustering as cl


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lane's product runs there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 64, 256])
def test_rows_on_card_within_bound_with_tf32_on(cuda, k):
    m, n = 16384, 128
    rng = np.random.default_rng(k)
    W = 100.0 + rng.random((m, n))
    W[: m // 8] *= 5.0
    sq = np.einsum("ij,ij->i", W, W)
    idx = rng.choice(m, size=k, replace=False)
    be = cl.get_distance_backend("torch", cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = be.seed_rows(be.prepare(W, sq), idx)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = cl._NumpyDistanceBackend().seed_rows((W, sq), idx)
    bound = be.row_error_coef(n) * (sq[idx][:, None] + sq[None, :])
    assert (np.abs(got - want) <= bound).all()
