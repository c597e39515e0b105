"""PyTorch port, flat layout (repro_torch.core.flat) vs repro.core.flat.

The port's unravel spec must be the reference's field for field — leaf
paths, shapes, dtypes, offsets, rows, lanes, block — so that the two
packages' (W, R, C) buffers compare element by element.  Templates are
shape-only on both sides (jax.eval_shape / meta tensors): nothing is
allocated, even at qwen2-0.5b's full width.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import abstract  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _templates(smoke: bool):
    get_j = jreg.smoke_arch if smoke else jreg.get_arch
    get_t = treg.smoke_arch if smoke else treg.get_arch
    cfg_j, cfg_t = get_j("qwen2-0.5b"), get_t("qwen2-0.5b")
    tj = jax.eval_shape(functools.partial(JT.init_params, cfg_j),
                        jax.random.PRNGKey(0))
    return tj, abstract(TT.model_defs(cfg_t))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_spec_meta_equals_reference(smoke):
    tj, tt = _templates(smoke)
    mj = jflat.make_spec(tj).meta()
    mt = tflat.make_spec(tt).meta()
    assert mt == mj
    if not smoke:
        # the main path's layout (qwen2-0.5b, full width)
        assert mt["size"] == 494_032_768
        assert (mt["rows"], mt["lanes"], mt["block"]) == (1_930_240, 256, 1024)
        assert len(mt["leaves"]) == 14
    else:
        assert mt["size"] == 541_696
        assert (mt["rows"], mt["lanes"], mt["block"]) == (2_560, 256, 512)


@pytest.mark.parametrize("block", [0, 8, 100])
def test_spec_meta_equals_reference_forced_block(block):
    tj, tt = _templates(smoke=True)
    assert (tflat.make_spec(tt, block=block).meta()
            == jflat.make_spec(tj, block=block).meta())


def _smoke_tree(rng, lead=()):
    """Random fp32 tree of the smoke template's shapes (+ ``lead`` axes)."""
    _, tt = _templates(smoke=True)
    return tm.tree_map(lambda m: torch.from_numpy(
        rng.randn(*lead, *m.shape).astype(np.float32)), tt)


def test_flat_roundtrip_exact():
    rng = np.random.RandomState(0)
    _, tt = _templates(smoke=True)
    spec = tflat.make_spec(tt)
    tree = _smoke_tree(rng)
    buf = tflat.flatten_tree(spec, tree)
    assert buf.shape == (spec.rows, spec.lanes)
    assert not buf.reshape(-1)[spec.size:].any()       # pad is zero
    out = tflat.unflatten_tree(spec, buf)
    for (pa, a), (pb, b) in zip(tm.leaves_with_path(tree),
                                tm.leaves_with_path(out)):
        assert pa == pb
        assert torch.equal(a, b)
        # unflatten returns views into the buffer
        assert b.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


def test_flat_roundtrip_stacked_exact():
    rng = np.random.RandomState(1)
    _, tt = _templates(smoke=True)
    spec = tflat.make_spec(tt)
    tree = _smoke_tree(rng, lead=(3,))
    buf = tflat.flatten_stacked(spec, tree)
    assert buf.shape == (3, spec.rows, spec.lanes)
    out = tflat.unflatten_stacked(spec, buf)
    for a, b in zip(tm.leaves(tree), tm.leaves(out)):
        assert torch.equal(a, b)
    # writing the buffer is seen through the views
    buf.add_(1.0)
    for a, b in zip(tm.leaves(tree), tm.leaves(out)):
        assert torch.equal(a + 1.0, b)


def test_flat_buffer_matches_reference_elementwise():
    """Same tree (numpy), both packages' stacked buffers: bitwise equal."""
    rng = np.random.RandomState(2)
    _, tt = _templates(smoke=True)
    tree_t = _smoke_tree(rng, lead=(2,))
    tree_np = tm.tree_map(lambda x: x.numpy(), tree_t)
    tj, _ = _templates(smoke=True)
    bj = np.asarray(jflat.flatten_stacked(jflat.make_spec(tj),
                                          jax.tree.map(np.asarray, tree_np)))
    bt = tflat.flatten_stacked(tflat.make_spec(tt), tree_t).numpy()
    np.testing.assert_array_equal(bt, bj)


def test_choose_block_matches_reference():
    for rows in [1, 3, 8, 17, 100, 1000, 1024, 5000, 100000, 1_929_669]:
        assert tflat.choose_block(rows) == jflat.choose_block(rows)


def test_flatten_rejects_mismatched_tree():
    _, tt = _templates(smoke=True)
    spec = tflat.make_spec(tt)
    bad = {"embed": torch.zeros(3, 3)}
    with pytest.raises(ValueError):
        tflat.flatten_tree(spec, bad)
