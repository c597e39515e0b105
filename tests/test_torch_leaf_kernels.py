"""PyTorch port, the tree-update API and its per-leaf kernels' plain
versions vs the JAX package.

* ``kernels/torch_update.vrl_local_update`` / ``vrl_sync_update`` and the
  tree wrappers ``kernels/ops.vrl_*_update_tree`` on the CPU are BITWISE
  the eager oracles ``repro.kernels.ref.vrl_update_ref`` /
  ``vrl_sync_ref``, applied as the reference's tree wrappers apply them
  (Δ cast to p's dtype before the local step; x̂ broadcast to p's shape),
  at (64, 64), (1000,), (3, 5, 7) and (4, 130, 7), fp32 and bf16.
* Against the reference's tree wrappers themselves (interpret-mode
  Pallas on the CPU) the port is within one fp32 ulp per element: Pallas
  contracts p − γ(g − Δ) and Δ + (x̂ − p)·inv_kg into one FMA each, which
  skips the rounding of the product.  The ulp is taken at the scale of
  the operation, max(|out|, |first term|, |product|).  The tests count
  the elements that differ and hold the count below a stated fraction:
  measured ~5 % for the local step (γ = 0.03) and ~29 % for the sync
  (k = 3, γ = 0.07); in bf16 the rounding to bf16 hides the difference
  and the two are bitwise equal.
* The sync multiplies by inv_kg = fp32(1/(kγ)) and does not divide by
  kγ: at k = 3, γ = 0.07 the divide form differs.
* x̂ broadcasts over a worker axis without being materialised (the kernel
  wrapper receives p's trailing shape).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import vrl_sync_ref, vrl_update_ref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

SHAPES = [(64, 64), (1000,), (3, 5, 7), (4, 130, 7)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LR, K, SYNC_LR = 0.03, 3, 0.07
# the share of elements where the unfused port and the FMA-contracted
# interpret-mode Pallas may differ (by one ulp each): measured ~5 % local,
# ~29 % sync
LOCAL_FRACTION, SYNC_FRACTION = 0.10, 0.40


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, shape, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _j(x, dt=jnp.float32):
    return jnp.asarray(x).astype(dt)


def _t(x, dt=torch.float32):
    return torch.from_numpy(np.array(x)).to(dt)


def _np(x):
    """An fp32 numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bitwise(got_t, want_j):
    assert str(got_t.dtype).split(".")[-1] == str(want_j.dtype)
    assert tuple(got_t.shape) == tuple(want_j.shape)
    np.testing.assert_array_equal(_np(got_t), _np(want_j))


def _ulp_count(got, want, *scales):
    """Elements of ``got`` that differ from ``want``, after asserting each
    is within one fp32 ulp at the operation's scale."""
    got, want = _np(got), _np(want)
    scale = np.maximum.reduce([np.abs(want)] + [np.abs(s) for s in scales])
    diff = np.abs(got - want)
    assert np.all(diff <= np.spacing(scale.astype(np.float32))), \
        float(diff.max())
    return int((diff > 0).sum())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_local_plain_and_tree_bitwise_eager_oracle(shape, dt):
    jdt, tdt = DTYPES[dt]
    p, g, d = _arrays(sum(shape), shape)
    want = vrl_update_ref(_j(p, jdt), _j(g, jdt), _j(d).astype(jdt), LR)
    _bitwise(tu.vrl_local_update(_t(p, tdt), _t(g, tdt), _t(d), lr=LR),
             want)
    got = tkernels.vrl_local_update_tree({"w": _t(p, tdt)},
                                         {"w": _t(g, tdt)}, {"w": _t(d)},
                                         lr=LR)
    _bitwise(got["w"], want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sync_plain_and_tree_bitwise_eager_oracle(shape, dt):
    """p and x̂ in the dtype, Δ fp32: p' in p's dtype, Δ' in Δ's."""
    jdt, tdt = DTYPES[dt]
    p, xb, d = _arrays(sum(shape) + 1, shape)
    inv_kg = 1.0 / (K * SYNC_LR)
    want_p, want_d = vrl_sync_ref(_j(p, jdt), _j(xb, jdt), _j(d), inv_kg)
    got_p, got_d = tu.vrl_sync_update(_t(p, tdt), _t(xb, tdt), _t(d),
                                      inv_kg=inv_kg)
    _bitwise(got_p, want_p)
    _bitwise(got_d, want_d)
    tp, td = tkernels.vrl_sync_update_tree({"w": _t(p, tdt)},
                                           {"w": _t(xb, tdt)}, {"w": _t(d)},
                                           k=K, lr=SYNC_LR)
    _bitwise(tp["w"], want_p)
    _bitwise(td["w"], want_d)


@pytest.mark.parametrize("shape", SHAPES)
def test_trees_within_one_ulp_of_pallas_interpret(shape):
    """fp32: every element within one ulp of the reference's tree wrappers
    (interpret-mode Pallas), the differing ones counted and held below
    the stated fractions; bf16: bitwise."""
    p, g, d = _arrays(sum(shape) + 2, shape)
    want = jops.vrl_local_update_tree({"w": _j(p)}, {"w": _j(g)},
                                      {"w": _j(d)}, lr=LR)["w"]
    got = tops.vrl_local_update_tree({"w": _t(p)}, {"w": _t(g)},
                                     {"w": _t(d)}, lr=LR)["w"]
    n_local = _ulp_count(got, want, p, LR * (g - d))
    assert n_local <= LOCAL_FRACTION * got.numel(), n_local
    xb = g
    wp, wd = jops.vrl_sync_update_tree({"w": _j(p)}, {"w": _j(xb)},
                                       {"w": _j(d)}, k=K, lr=SYNC_LR)
    gp, gd = tops.vrl_sync_update_tree({"w": _t(p)}, {"w": _t(xb)},
                                       {"w": _t(d)}, k=K, lr=SYNC_LR)
    _bitwise(gp["w"], wp["w"])
    n_sync = _ulp_count(gd["w"], wd["w"], d, (xb - p) / (K * SYNC_LR))
    assert n_sync <= SYNC_FRACTION * gd["w"].numel(), n_sync
    print(f"{shape}: {n_local} local and {n_sync} sync elements of "
          f"{got.numel()} one ulp off interpret-mode Pallas")
    # bf16: rounding the fp32 result to bf16 hides the FMA's ulp
    bj, bt = DTYPES["bf16"]
    want = jops.vrl_local_update_tree({"w": _j(p, bj)}, {"w": _j(g, bj)},
                                      {"w": _j(d)}, lr=LR)["w"]
    got = tops.vrl_local_update_tree({"w": _t(p, bt)}, {"w": _t(g, bt)},
                                     {"w": _t(d)}, lr=LR)["w"]
    _bitwise(got, want)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 500), lr=st.floats(1e-4, 1.0),
       seed=st.integers(0, 1000))
def test_local_update_arbitrary_sizes(n, lr, seed):
    """Any leaf size (no padding in the port): bitwise the eager oracle,
    within one ulp of interpret-mode Pallas (the reference's
    ``tests/test_kernel_properties.py`` case)."""
    p, g, d = _arrays(seed, (n,))
    got = tops.vrl_local_update_tree({"w": _t(p)}, {"w": _t(g)},
                                     {"w": _t(d)}, lr=lr)["w"]
    _bitwise(got, vrl_update_ref(_j(p), _j(g), _j(d), lr))
    want = jops.vrl_local_update_tree({"w": _j(p)}, {"w": _j(g)},
                                      {"w": _j(d)}, lr=lr)["w"]
    _ulp_count(got, want, p, np.float32(lr) * (g - d))


def test_sync_multiplies_by_inv_kg():
    """inv_kg = fp32(1/(kγ)) formed in double on the host: the port is
    bitwise the product form, and the division by the fp32 k·γ (what the
    engine's fused_sync_vrl does) differs at k = 3, γ = 0.07."""
    p, xb, d = _arrays(5, (910,))
    _, got = tops.vrl_sync_update_tree({"w": _t(p)}, {"w": _t(xb)},
                                       {"w": _t(d)}, k=K, lr=SYNC_LR)
    got = got["w"].numpy()
    inv = np.float32(1.0 / (K * SYNC_LR))
    np.testing.assert_array_equal(got, d + (xb - p) * inv)
    kg = np.float32(K) * np.float32(SYNC_LR)
    divided = d + (xb - p) / kg
    assert (got != divided).sum() > 0


@pytest.mark.parametrize("xb_shape", ["trailing", "keepdims", "full"])
def test_sync_xbar_broadcast_over_workers(xb_shape, monkeypatch):
    """x̂ of p's shape without the worker axis (or keepdims (1, ...)) is
    applied to every worker, bitwise the oracle on the broadcast, and
    reaches the kernel wrapper unexpanded as p's trailing shape."""
    w, shape = 4, (130, 7)
    p, d = _arrays(6, (w,) + shape, n=2)
    xb = _arrays(7, shape, n=1)[0]
    xb_in = {"trailing": xb, "keepdims": xb[None],
             "full": np.broadcast_to(xb, (w,) + shape)}[xb_shape]
    seen = []
    kernel = tvu.vrl_sync_update

    def spy(p_, xbar, d_, **kw):
        seen.append(tuple(xbar.shape))
        return kernel(p_, xbar, d_, **kw)
    monkeypatch.setattr(tvu, "vrl_sync_update", spy)
    gp, gd = tops.vrl_sync_update_tree({"w": _t(p)}, {"w": _t(xb_in)},
                                       {"w": _t(d)}, k=2, lr=0.05)
    want_p, want_d = vrl_sync_ref(_j(p), _j(np.broadcast_to(xb, p.shape)),
                                  _j(d), 1.0 / (2 * 0.05))
    _bitwise(gp["w"], want_p)
    _bitwise(gd["w"], want_d)
    assert seen == [((w,) + shape) if xb_shape == "full" else shape]


def test_cpu_wrappers_launch_nothing_and_check_operands():
    """On CPU tensors the wrappers run the plain versions (no launch);
    they refuse an operand that is not fp32/bf16, of another shape, or
    an x̂ that is not a trailing part of p's shape."""
    p, g, d = (_t(x) for x in _arrays(8, (3, 16)))
    n0 = dict(tvu.LAUNCHES)
    assert torch.equal(tvu.vrl_local_update(p, g, d, lr=0.1),
                       tu.vrl_local_update(p, g, d, lr=0.1))
    out = tvu.vrl_sync_update(p, g[0], d, inv_kg=2.0)
    for a, b in zip(out, tu.vrl_sync_update(p, g[0], d, inv_kg=2.0)):
        assert torch.equal(a, b)
    assert tvu.LAUNCHES == n0
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        tvu.vrl_local_update(p, g.double(), d, lr=0.1)
    with pytest.raises(ValueError, match="g"):
        tvu.vrl_local_update(p, g[:2], d, lr=0.1)
    with pytest.raises(ValueError, match="trailing"):
        tvu.vrl_sync_update(p, g[:, :4].contiguous(), d, inv_kg=2.0)
    with pytest.raises(ValueError, match="broadcast"):
        tops.vrl_sync_update_tree({"w": p}, {"w": g[:2]}, {"w": d}, k=1,
                                  lr=0.1)


def test_tree_wrappers_keep_structure_and_dtypes():
    """Nested trees, a bf16 leaf beside fp32 ones, bf16 Δ with fp32 p:
    the outputs have each leaf's structure and dtype (p' in p's, Δ' in
    Δ's), as the reference's wrappers return them."""
    rng = np.random.RandomState(9)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}

    def tree(dt=torch.float32):
        return {"a": _t(rng.randn(5, 3), dt),
                "b": {"c": _t(rng.randn(7), dt),
                      "d": _t(rng.randn(2, 2, 2), torch.bfloat16)}}
    p, g, d = tree(), tree(), tree(torch.bfloat16)
    out = tops.vrl_local_update_tree(p, g, d, lr=0.1)
    po, do = tops.vrl_sync_update_tree(p, g, d, k=2, lr=0.1)
    assert out["b"]["d"].dtype == torch.bfloat16
    assert out["a"].dtype == torch.float32 and out["a"].shape == (5, 3)
    assert do["a"].dtype == torch.bfloat16 and po["a"].dtype == torch.float32
    assert set(po["b"]) == set(shapes["b"])
