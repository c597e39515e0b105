"""The port's data, loss and MLP modules of the paper's workload against the
JAX package's, on the CPU.

``repro_torch.data`` (synthetic sets, partitions, ``WorkerLoader``) is pure
numpy with the reference's draws in the reference's order, so it is held
BITWISE to ``repro.data`` across seeds and sizes (hypothesis over the
partitioners, as ``tests/test_partition_properties.py`` does for the
reference).  ``cross_entropy_cls`` and ``accuracy`` agree with
``repro.train.loss`` within 1e-6, and the MLP of ``repro_torch.paper``
(``mlp_loss`` and the per-worker gradients) with ``benchmarks/common.py``'s
within 1e-6, from the reference's parameters carried across.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common  # noqa: E402
from repro import data as rdata  # noqa: E402
from repro.train import loss as rloss  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.configs import paper_mlp as tpaper_mlp  # noqa: E402
from repro_torch.paper import task  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402

from repro.configs import paper_mlp as rpaper_mlp  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_data(a, b):
    assert a.num_classes == b.num_classes
    for x, y in ((a.x, b.x), (a.y, b.y)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _same_parts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ synthetic
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,dim,classes", [(64, 8, 3), (1000, 32, 10),
                                           (4096, 256, 64)])
def test_feature_classification_bitwise(seed, n, dim, classes):
    _same_data(rdata.feature_classification(n, dim, classes, seed=seed),
               tdata.feature_classification(n, dim, classes, seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n,dim,classes,sep", [(100, 16, 4, 3.0),
                                               (2048, 64, 10, 1.5)])
def test_gaussian_classification_bitwise(seed, n, dim, classes, sep):
    _same_data(
        rdata.gaussian_classification(n, dim, classes, sep=sep, seed=seed),
        tdata.gaussian_classification(n, dim, classes, sep=sep, seed=seed))


def test_feature_classification_defaults_bitwise():
    """The paper width's data (n 8192, dim 2048, 200 classes)."""
    _same_data(rdata.feature_classification(),
               tdata.feature_classification())


@pytest.mark.parametrize("identical", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_lm_token_stream_bitwise(identical, seed):
    kw = dict(alpha=0.3, identical=identical, seed=seed)
    want = rdata.lm_token_stream(3, 16, 50, 4, 2, **kw)
    got = tdata.lm_token_stream(3, 16, 50, 4, 2, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the trivial assignment gives the same stream
    np.testing.assert_array_equal(
        tdata.assigned_token_stream(tdata.contiguous_assignment(3, 3), 16,
                                    50, 4, 2, **kw), got)


# ----------------------------------------------------------- partitions
@pytest.mark.parametrize("seed", [0, 2, 11])
@pytest.mark.parametrize("workers", [1, 5, 8])
def test_class_shard_partition_bitwise(seed, workers):
    y = rdata.feature_classification(1000, 4, 20, seed=seed).y
    _same_parts(rdata.class_shard_partition(y, workers, seed),
                tdata.class_shard_partition(y, workers, seed))


@settings(max_examples=40, deadline=None)
@given(n_classes=st.integers(1, 8), n=st.integers(1, 200),
       workers=st.integers(1, 12), alpha=st.floats(0.01, 10.0),
       seed=st.integers(0, 2 ** 16))
def test_dirichlet_partition_bitwise(n_classes, n, workers, alpha, seed):
    labels = np.arange(n) % n_classes
    if n < workers:
        with pytest.raises(ValueError,
                           match="cannot give every worker an index"):
            tdata.dirichlet_partition(labels, workers, alpha, seed)
        return
    _same_parts(rdata.dirichlet_partition(labels, workers, alpha, seed),
                tdata.dirichlet_partition(labels, workers, alpha, seed))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 300), workers=st.integers(1, 12),
       seed=st.integers(0, 2 ** 16))
def test_iid_partition_bitwise(n, workers, seed):
    _same_parts(rdata.iid_partition(n, workers, seed),
                tdata.iid_partition(n, workers, seed))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 200), w0=st.integers(1, 12), w1=st.integers(1, 12),
       seed=st.integers(0, 2 ** 10))
def test_repartition_and_meta_bitwise(n, w0, w1, seed):
    if n < w0:
        return
    parts = rdata.iid_partition(n, w0, seed=seed)
    if n < w1:
        with pytest.raises(ValueError,
                           match="cannot give every worker an index"):
            tdata.repartition(parts, w1)
        return
    _same_parts(rdata.repartition(parts, w1), tdata.repartition(parts, w1))
    meta = tdata.assignment_to_meta(parts)
    assert meta == rdata.assignment_to_meta(parts)
    _same_parts(rdata.assignment_from_meta(meta),
                tdata.assignment_from_meta(meta))


def test_partition_refusals_match():
    for fn in (rdata.repartition, tdata.repartition):
        with pytest.raises(ValueError, match="num_workers must be >= 1"):
            fn([np.arange(3)], 0)
    for fn in (rdata.contiguous_assignment, tdata.contiguous_assignment):
        with pytest.raises(ValueError, match="cannot give every unit"):
            fn(2, 3)


@pytest.mark.parametrize("seed", [0, 4])
def test_label_skew_equal(seed):
    y = rdata.feature_classification(2000, 4, 16, seed=seed).y
    for parts in (rdata.class_shard_partition(y, 4, seed),
                  rdata.dirichlet_partition(y, 4, 0.3, seed),
                  rdata.iid_partition(len(y), 4, seed)):
        assert tdata.label_skew(y, parts) == rdata.label_skew(y, parts)


# --------------------------------------------------------------- loader
@pytest.mark.parametrize("partition", ["class_shard", "dirichlet", "iid"])
@pytest.mark.parametrize("seed", [0, 9])
def test_worker_loader_first_50_batches_bitwise(partition, seed):
    data = rdata.feature_classification(n=1500, dim=16, num_classes=24,
                                        seed=seed)
    ref = iter(rdata.WorkerLoader(data, 8, 32, partition=partition,
                                  alpha=0.2, seed=seed))
    got = iter(tdata.WorkerLoader(data, 8, 32, partition=partition,
                                  alpha=0.2, seed=seed))
    for _ in range(50):
        (xr, yr), (xg, yg) = next(ref), next(got)
        assert xg.dtype == xr.dtype and yg.dtype == yr.dtype
        np.testing.assert_array_equal(xg, xr)
        np.testing.assert_array_equal(yg, yr)


def test_worker_loader_refuses_an_unknown_partition():
    data = tdata.feature_classification(64, 4, 4)
    with pytest.raises(ValueError):
        tdata.WorkerLoader(data, 2, 4, partition="zipf")


def test_data_exports_match_the_reference():
    want = {n for n in dir(rdata) if not n.startswith("_")} - {
        "loader", "partition", "synthetic"}
    got = {n for n in dir(tdata) if not n.startswith("_")}
    assert want <= got


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_cross_entropy_cls_and_accuracy(lead):
    rng = np.random.RandomState(len(lead))
    logits = (rng.randn(*lead, 17, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, size=(*lead, 17)).astype(np.int32)
    want = float(rloss.cross_entropy_cls(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = float(tloss.cross_entropy_cls(torch.from_numpy(logits),
                                        torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    want = float(rloss.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tloss.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6


def test_cross_entropy_cls_bf16_logits_read_as_fp32():
    rng = np.random.RandomState(3)
    logits = rng.randn(9, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=9)
    want = float(rloss.cross_entropy_cls(
        jnp.asarray(logits, dtype=jnp.bfloat16), jnp.asarray(labels)))
    got = float(tloss.cross_entropy_cls(
        torch.from_numpy(logits).to(torch.bfloat16),
        torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# -------------------------------------------------------------- the MLP
def test_paper_mlp_config_matches():
    assert tpaper_mlp.CONFIG == tpaper_mlp.MLPConfig()
    for f in ("name", "in_dim", "hidden", "classes"):
        assert getattr(tpaper_mlp.CONFIG, f) == getattr(rpaper_mlp.CONFIG, f)


def test_mlp_init_shapes_scale_and_seed():
    p = task.mlp_init(3, in_dim=64, hidden=32, classes=10)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (64, 32), "b1": (32,), "w2": (32, 10), "b2": (10,)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not p["b1"].any() and not p["b2"].any()
    # w ~ N(0, 1)/sqrt(fan-in), as the reference's
    assert abs(p["w1"].std().item() * 8 - 1) < 0.1
    again = task.mlp_init(3, in_dim=64, hidden=32, classes=10)
    assert all(torch.equal(p[k], again[k]) for k in p)
    other = task.mlp_init(4, in_dim=64, hidden=32, classes=10)
    assert not torch.equal(p["w1"], other["w1"])


def _jax_mlp(seed, in_dim, hidden, classes):
    p = common.mlp_init(jax.random.PRNGKey(seed), in_dim=in_dim,
                        hidden=hidden, classes=classes)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_loss_matches_the_reference(seed):
    data = rdata.feature_classification(n=256, dim=64, num_classes=12,
                                        seed=seed)
    jp, tp = _jax_mlp(seed, 64, 32, 12)
    want = float(common.mlp_loss(jp, jnp.asarray(data.x),
                                 jnp.asarray(data.y)))
    got = float(task.mlp_loss(tp, torch.from_numpy(data.x),
                              torch.from_numpy(data.y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_worker_grads_match_the_reference():
    """Each worker's gradient at its own parameters (worker-stacked, as
    the executors hold them) against ``jax.vmap(jax.value_and_grad)`` of
    the reference's ``mlp_loss``, within 1e-6."""
    w = 4
    data = rdata.feature_classification(n=512, dim=64, num_classes=12,
                                        seed=2)
    xs, ys = next(iter(rdata.WorkerLoader(data, w, 16, seed=2)))
    jp, _ = _jax_mlp(2, 64, 32, 12)
    # distinct workers: each leaf moved by a worker-dependent offset
    stacked = {k: jnp.stack([v + 0.01 * i for i in range(w)])
               for k, v in jp.items()}
    _, want = jax.vmap(jax.value_and_grad(common.mlp_loss))(
        stacked, jnp.asarray(xs), jnp.asarray(ys))
    got = task.worker_grads(
        {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()},
        torch.from_numpy(xs), torch.from_numpy(ys))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
