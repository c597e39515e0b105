"""PyTorch port, qwen2-0.5b model (smoke size) vs repro.models.transformer.

The JAX parameters are carried across with ``from_numpy`` (``jax.random``
cannot be re-drawn in torch); the same numpy tokens go through both
forwards, and through ``jax.value_and_grad`` / ``torch.autograd.grad`` of
the LM cross-entropy.

Tolerances (fp32): the two frameworks sum matmuls and reductions in other
orders, and this model amplifies ulps: its init rule takes fan-in as
``shape[-2]`` (the head count for wq/wk), so wq/wk entries have std 0.5-1
and the attention scores are large.  Measured on this input, each fp32
forward (JAX's and the port's) is 2-4e-5 away from a float64 evaluation
of the same parameters, with logits of magnitude ~1.  Logits: atol 1e-4.
Loss: rtol 1e-5.  Gradients: per leaf, atol 1e-3 · max|g| (the tied
embedding's gradient sums over every token and both of its uses).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.flat import make_spec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.loss import cross_entropy_lm as j_ce  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.train.loss import cross_entropy_lm as t_ce  # noqa: E402

CFG_J = jreg.smoke_arch("qwen2-0.5b")
CFG_T = treg.smoke_arch("qwen2-0.5b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    pj = JT.init_params(CFG_J, jax.random.PRNGKey(0))
    return pj, from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(seed=0, b=2, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG_T.vocab_size, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=-1)


def test_configs_match_reference():
    for name in ("qwen2-0.5b",):
        assert (jreg.get_arch(name).__dict__ == treg.get_arch(name).__dict__)
        assert (jreg.smoke_arch(name).__dict__
                == treg.smoke_arch(name).__dict__)
        assert (jreg.get_arch(name).param_count()
                == treg.get_arch(name).param_count())


def test_param_tree_matches_reference(params):
    pj, pt = params
    jpaths = [("/".join(str(k.key) for k in path), tuple(x.shape))
              for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]]
    tpaths = [(path, tuple(x.shape)) for path, x in tm.leaves_with_path(pt)]
    assert tpaths == jpaths
    # init rules: same leaves, same kinds of values
    defs = tm.leaves_with_path(TT.model_defs(CFG_T))
    assert [p for p, _ in defs] == [p for p, _ in tpaths]
    fresh = TT.init_params(CFG_T, seed=0)
    for (path, a), (_, b) in zip(tm.leaves_with_path(fresh),
                                 tm.leaves_with_path(pt)):
        if "norm" in path:
            assert torch.all(a == 1) and torch.all(b == 1), path
        elif path.split("/")[-1] in ("bq", "bk", "bv"):
            assert not a.any() and not b.any(), path
        else:
            assert abs(a.std().item() / b.std().item() - 1) < 0.1, path
    assert make_spec(pj).size == CFG_T.param_count() + CFG_T.d_model


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_reference(params, seed):
    pj, pt = params
    toks, _ = _tokens(seed)
    want, _ = JT.forward(CFG_J, pj, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(CFG_T, pt, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 16, CFG_T.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_loss_and_grads_match_reference(params):
    pj, pt = params
    toks, labels = _tokens(2)

    def jloss(p):
        logits, _ = JT.forward(CFG_J, p, jnp.asarray(toks))
        return j_ce(logits, jnp.asarray(labels))

    lj, gj = jax.value_and_grad(jloss)(pj)
    pairs = tm.leaves_with_path(pt)
    leaves = [x.clone().requires_grad_() for _, x in pairs]
    p = tm.from_paths([(path, x) for (path, _), x in zip(pairs, leaves)])
    lt = t_ce(TT.forward(CFG_T, p, torch.from_numpy(toks).long()),
              torch.from_numpy(labels).long())
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    gj_leaves = jax.tree.leaves(gj)
    assert len(gj_leaves) == len(gt)
    for (path, _), a, b in zip(pairs, gj_leaves, gt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-3 * np.abs(a).max() + 1e-12,
                                   err_msg=path)
