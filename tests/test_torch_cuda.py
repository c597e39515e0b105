"""PyTorch port, CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
visible — the kernels are built with nvcc and run only on the card.  No
JAX here, so the file runs on a machine with PyTorch alone:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Required: bitwise equality with ``kernels/torch_update`` (the library is
built with -fmad=false and IEEE division), on a tile-aligned and a ragged
row count, with and without Δ, wd 0 and non-zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

W, R, C = 3, 16, 256
LOCAL_CASES = [(use_d, lr, wd) for use_d in (False, True)
               for lr, wd in ((0.05, 0.0), (0.05, 1e-4), (0.2, 1e-4))]


def _inputs(seed, r):
    rng = np.random.RandomState(seed)
    p, g, d = (rng.randn(W, r, C).astype(np.float32) for _ in range(3))
    xbar = rng.randn(r, C).astype(np.float32)
    return p, g, d, xbar


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
@pytest.mark.parametrize("r", [R, 1237])
def test_cuda_kernels_local_sgd_bitwise(use_d, lr, wd, r):
    dev = _cuda_or_skip()
    p, g, d, _ = (torch.from_numpy(x).to(dev) for x in _inputs(5, r=r))
    d = d if use_d else None
    want = tu.fused_local_sgd(p, g, d, lr=lr, wd=wd)
    n0 = tvu.LAUNCHES["fused_local_sgd"]
    got = tvu.fused_local_sgd(p, g, d, lr=lr, wd=wd)
    torch.cuda.synchronize()
    assert tvu.LAUNCHES["fused_local_sgd"] == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [R, 1237])
def test_cuda_kernels_sync_vrl_bitwise(r):
    dev = _cuda_or_skip()
    p, _, d, xbar = (torch.from_numpy(x).to(dev) for x in _inputs(6, r=r))
    scal = torch.full((1, 1), 3.0, device=dev) * 0.05
    want_p, want_d = tu.fused_sync_vrl(p, xbar, d, scal)
    n0 = tvu.LAUNCHES["fused_sync_vrl"]
    got_p, got_d = tvu.fused_sync_vrl(p, xbar, d, scal)
    torch.cuda.synchronize()
    assert tvu.LAUNCHES["fused_sync_vrl"] == n0 + 1
    assert torch.equal(got_p, want_p) and torch.equal(got_d, want_d)
