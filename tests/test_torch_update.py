"""PyTorch port, engine update kernels: plain versions vs the JAX package.

``repro_torch.kernels.torch_update`` (the plain PyTorch versions, which
CPU tensors take and the CUDA kernels are held against) must reproduce
``repro.kernels.xla_update`` BITWISE on the same numpy inputs.  Against the
Pallas kernels of ``repro.kernels.vrl_update`` run in interpret mode:

* ``fused_sync_vrl``: bitwise.
* ``fused_local_sgd``: within one rounding of γ·v.  Interpret-mode Pallas
  on the CPU contracts the last op, p − γ·v, into one FMA (γ·v is never
  rounded); the plain version, ``xla_update`` and the CUDA kernel (built
  with -fmad=false) round γ·v first.  So |plain − pallas| ≤ ulp(γ·v) +
  ulp(p'), elementwise.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
(marked ``cuda``) compares them with the plain versions bitwise there and
skips elsewhere.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

W, R, C, BLOCK = 3, 16, 256, 8


def _inputs(seed=0, w=W, r=R, c=C):
    rng = np.random.RandomState(seed)
    p, g, d = (rng.randn(w, r, c).astype(np.float32) for _ in range(3))
    xbar = rng.randn(r, c).astype(np.float32)
    return p, g, d, xbar


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


LOCAL_CASES = [(use_d, lr, wd) for use_d in (False, True)
               for lr, wd in ((0.05, 0.0), (0.05, 1e-4), (0.2, 1e-4))]


@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
def test_plain_local_sgd_bitwise_xla(use_d, lr, wd):
    p, g, d, _ = _inputs()
    d = d if use_d else None
    want = np.asarray(jxu.fused_local_sgd(_j(p), _j(g), _j(d), lr=lr, wd=wd))
    got = tu.fused_local_sgd(_t(p), _t(g), _t(d), lr=lr, wd=wd).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
def test_plain_local_sgd_vs_pallas_interpret(use_d, lr, wd):
    p, g, d, _ = _inputs(seed=1)
    d = d if use_d else None
    want = np.asarray(jvu.fused_local_sgd(_j(p), _j(g), _j(d), lr=lr, wd=wd,
                                          block=BLOCK, interpret=True))
    got = tu.fused_local_sgd(_t(p), _t(g), _t(d), lr=lr, wd=wd).numpy()
    # one rounding of γ·v apart (the FMA contraction named above)
    v = g - d if use_d else g
    if wd:
        v = v + np.float32(wd) * p
    lv = np.float32(lr) * v
    tol = np.spacing(np.abs(lv)) + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("kg", [0.05, 3 * 0.05, 0.7])
def test_plain_sync_vrl_bitwise(kg):
    p, _, d, xbar = _inputs(seed=2)
    scal = np.array([[kg]], np.float32)
    got_p, got_d = tu.fused_sync_vrl(_t(p), _t(xbar), _t(d), _t(scal))
    for ref in (jxu.fused_sync_vrl(_j(p), _j(xbar), _j(d), _j(scal)),
                jvu.fused_sync_vrl(_j(p), _j(xbar), _j(d), _j(scal),
                                   block=BLOCK, interpret=True)):
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref[1]))


def test_wrappers_on_cpu_write_in_place_and_count_no_launch():
    p, g, d, xbar = _inputs(seed=3)
    tp, tg, td = _t(p), _t(g), _t(d)
    tvu.reset_launches()
    out = tvu.fused_local_sgd(tp, tg, td, lr=0.1, wd=1e-4)
    assert out is tp
    want = tu.fused_local_sgd(_t(p), tg, td, lr=0.1, wd=1e-4)
    assert torch.equal(tp, want)
    scal = torch.tensor([[0.3]], dtype=torch.float32)
    p0 = tp.clone()
    op, od = tvu.fused_sync_vrl(tp, _t(xbar), td, scal)
    assert op is tp and od is td
    wp, wd_ = tu.fused_sync_vrl(p0, _t(xbar), _t(d), scal)
    assert torch.equal(tp, wp) and torch.equal(td, wd_)
    # a CPU call runs the plain version: it is not a kernel launch
    assert tvu.LAUNCHES == {"fused_local_sgd": 0, "fused_sync_vrl": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    p, g, d, xbar = (_t(x) for x in _inputs(seed=4))
    scal = torch.ones(1, 1)
    with pytest.raises(TypeError):
        tvu.fused_local_sgd(p.double(), g.double(), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p, g[:, :-1], lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p, g.transpose(1, 2).contiguous()
                            .transpose(1, 2), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p[..., :6].contiguous(),
                            g[..., :6].contiguous(), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_sync_vrl(p, xbar[:-1], d, scal)
    with pytest.raises(ValueError):
        tvu.fused_sync_vrl(p, xbar, d, torch.ones(2))
