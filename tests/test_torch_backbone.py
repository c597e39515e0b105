"""PyTorch port, the dense backbone's four further architectures vs the
JAX package: stablelm-3b (dense MHA, head_dim 80 at full width, untied),
gemma-7b (GeGLU, tied, 256k vocabulary), musicgen-large (audio: plain
GELU MLP, codec frontend over frame embeddings) and chameleon-34b (vlm:
GQA over early-fusion token ids), each at the smoke size.

The JAX parameters are carried across with ``from_numpy``; the same numpy
inputs (token ids, or for the codec frontend float frame embeddings) go
through both packages.  Tolerances as ``tests/test_torch_model.py``
(fp32; the two frameworks sum in other orders): logits atol 1e-4, loss
rtol 1e-5, gradients per leaf atol 1e-3 · max|g|; hidden states (the
post-final-norm activations, of unit RMS) atol 1e-4 · max|h|; prefill
against step-by-step decode 5e-4, as the reference's
``test_prefill_then_decode_continuation``.  ``remat`` only recomputes
the same operations, so its gradients are bitwise those without it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.loss import cross_entropy_lm as j_ce  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import abstract, from_numpy  # noqa: E402
from repro_torch.train.loss import cross_entropy_lm as t_ce  # noqa: E402

ARCHS = ["stablelm-3b", "gemma-7b", "musicgen-large", "chameleon-34b"]
# the materialised tree beside the reference's analytic count: the final
# norm (d) it leaves out, and for the codec frontend frontend_proj too
TREE_EXCESS = {"stablelm-3b": 2560, "gemma-7b": 3072,
               "musicgen-large": 2048 * 2048 + 2048, "chameleon-34b": 8192}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jreg.smoke_arch(arch), treg.smoke_arch(arch)


_PARAMS: dict = {}


def _params(arch):
    """(JAX params, the same values in the port), drawn once per arch."""
    if arch not in _PARAMS:
        cj, _ = _cfgs(arch)
        pj = JT.init_params(cj, jax.random.PRNGKey(0))
        _PARAMS[arch] = pj, from_numpy(jax.tree.map(np.asarray, pj))
    return _PARAMS[arch]


def _inputs(cfg, seed=0, b=2, s=16):
    """numpy inputs (ids, or frame embeddings for the codec frontend) and
    next-token labels."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    if cfg.frontend == "codec":
        return rng.randn(b, s, cfg.frontend_dim).astype(np.float32), labels
    toks = rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=-1)


def _port(x):
    t = torch.from_numpy(np.asarray(x))
    return t.long() if not t.is_floating_point() else t


def _leaves_requiring_grad(pt):
    pairs = tm.leaves_with_path(pt)
    leaves = [x.clone().requires_grad_() for _, x in pairs]
    return pairs, leaves, tm.from_paths(
        [(path, x) for (path, _), x in zip(pairs, leaves)])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    cj, ct = jreg.get_arch(arch), treg.get_arch(arch)
    assert cj.__dict__ == ct.__dict__
    assert jreg.smoke_arch(arch).__dict__ == treg.smoke_arch(arch).__dict__
    assert cj.param_count() == ct.param_count()
    assert jreg.describe(arch) == treg.describe(arch)


def test_registry_offers_ten_architectures():
    assert treg.list_archs() == sorted(
        ["qwen2-0.5b", "granite-3-2b", "mamba2-370m", "hymba-1.5b",
         "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"] + ARCHS)
    assert treg.list_archs() == jreg.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_materialised_count_beside_param_count(arch):
    """At full width (meta tensors, nothing allocated): the tree holds the
    reference's count plus the final norm, and musicgen-large's
    frontend_proj (4,194,304), which the reference's formula leaves out
    too."""
    for cfg in (treg.get_arch(arch), treg.smoke_arch(arch)):
        n = sum(x.numel() for x in tm.leaves(abstract(TT.model_defs(cfg))))
        excess = cfg.d_model + (cfg.frontend_dim * cfg.d_model
                                if cfg.frontend == "codec" else 0)
        assert n == cfg.param_count() + excess
    full = treg.get_arch(arch)
    n = sum(x.numel() for x in tm.leaves(abstract(TT.model_defs(full))))
    assert n - full.param_count() == TREE_EXCESS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    pj, pt = _params(arch)
    jpaths = [("/".join(str(k.key) for k in path), tuple(x.shape))
              for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]]
    assert [(p, tuple(x.shape)) for p, x in tm.leaves_with_path(pt)] == \
        jpaths
    _, ct = _cfgs(arch)
    fresh = TT.init_params(ct, seed=0)
    for (path, a), (_, b) in zip(tm.leaves_with_path(fresh),
                                 tm.leaves_with_path(pt)):
        if "norm" in path:
            assert torch.all(a == 1) and torch.all(b == 1), path
        else:
            assert abs(a.std().item() / b.std().item() - 1) < 0.1, path


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    """The three MLPs at the smoke width: the same leaves, and the output
    within fp32 rounding (GELU tanh-approximated on both sides)."""
    cj, ct = (dataclasses.replace(c, mlp_act=act)
              for c in _cfgs("gemma-7b"))
    jdefs, tdefs = JL.mlp_defs(cj), TL.mlp_defs(ct)
    assert sorted(jdefs) == sorted(tdefs)
    assert all(jdefs[k].shape == tdefs[k].shape for k in jdefs)
    rng = np.random.RandomState(3)
    p = {k: (rng.randn(*d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in jdefs.items()}
    x = rng.randn(2, 5, ct.d_model).astype(np.float32)
    want = np.asarray(JL.mlp(cj, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x)))
    got = TL.mlp(ct, from_numpy(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_reference(arch, seed):
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    x, _ = _inputs(ct, seed)
    want, _ = JT.forward(cj, pj, jnp.asarray(x))
    with torch.no_grad():
        got = TT.forward(ct, pt, _port(x))
    assert got.shape == want.shape == (2, 16, ct.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_return_hidden_matches_reference(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    x, _ = _inputs(ct, 4)
    want, _ = JT.forward(cj, pj, jnp.asarray(x), return_hidden=True)
    want = np.asarray(want)
    with torch.no_grad():
        got = TT.forward(ct, pt, _port(x), return_hidden=True)
        logits = TT.forward(ct, pt, _port(x))
    assert got.shape == want.shape == (2, 16, ct.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the head applied to them gives forward's logits
    head = pt["embed"].T if ct.tie_embeddings else pt["lm_head"]
    np.testing.assert_allclose((got @ head).numpy(), logits.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    x, labels = _inputs(ct, 2)

    def jloss(p):
        logits, _ = JT.forward(cj, p, jnp.asarray(x))
        return j_ce(logits, jnp.asarray(labels))

    lj, gj = jax.value_and_grad(jloss)(pj)
    pairs, leaves, p = _leaves_requiring_grad(pt)
    lt = t_ce(TT.forward(ct, p, _port(x)), _port(labels))
    gt = torch.autograd.grad(lt, leaves, allow_unused=True)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    gj_leaves = jax.tree.leaves(gj)
    assert len(gj_leaves) == len(gt)
    for (path, _), a, b in zip(pairs, gj_leaves, gt):
        a = np.asarray(a)
        if b is None:
            # the codec frontend's untied model never reads embed
            assert ct.frontend == "codec" and path == "embed"
            assert not a.any()
            continue
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-3 * np.abs(a).max() + 1e-12,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise(arch):
    """``forward(remat=True)`` recomputes each block in the backward: the
    loss and every gradient are bitwise those without it, also for the
    stacked layer leaves (the checkpoint takes the unbound views)."""
    _, ct = _cfgs(arch)
    _, pt = _params(arch)
    x, labels = _inputs(ct, 5)
    out = []
    for remat in (False, True):
        pairs, leaves, p = _leaves_requiring_grad(pt)
        loss = t_ce(TT.forward(ct, p, _port(x), remat=remat), _port(labels))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for (path, _), a, b in zip(pairs, g0, g1):
        assert (a is None and b is None) or torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Prefill logits and the KV cache leaf by leaf against the JAX
    package's (fp32 cache)."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    x, _ = _inputs(ct, 6, b=2, s=8)
    lj, cjc = JT.prefill(cj, pj, jnp.asarray(x), 16)
    with torch.no_grad():
        lt, ctc = TT.prefill(ct, pt, _port(x), 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    assert sorted(ctc) == sorted(cjc)
    for key in cjc:
        want = np.asarray(cjc[key])
        np.testing.assert_allclose(ctc[key].numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continuation(arch):
    """The reference's ``test_prefill_then_decode_continuation`` on the
    port: prefill's last logits equal step-by-step decode's within 5e-4,
    and one more step from either cache agrees; for the codec frontend
    every input is a frame embedding (B, 1, F), the continuation one more
    drawn frame."""
    _, ct = _cfgs(arch)
    _, pt = _params(arch)
    x, _ = _inputs(ct, 7, b=1, s=8)
    x = _port(x)
    with torch.no_grad():
        logits_pf, cache_pf = TT.prefill(ct, pt, x, 16)
        cache = TT.init_cache(ct, 1, 16, dtype=torch.float32)
        for i in range(8):
            logits_st, cache = TT.decode_step(ct, pt, cache, x[:, i:i + 1],
                                              i)
        err = (logits_pf[:, -1] - logits_st[:, 0]).abs().max().item()
        assert err < 5e-4, err
        if ct.frontend == "codec":
            nxt, _ = _inputs(ct, 8, b=1, s=1)
            nxt = _port(nxt)
        else:
            nxt = torch.argmax(logits_st[:, -1:], -1)
        l1, _ = TT.decode_step(ct, pt, cache_pf, nxt, 8)
        l2, _ = TT.decode_step(ct, pt, cache, nxt, 8)
    assert (l1 - l2).abs().max().item() < 5e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """One decode step from the same prefilled cache, against JAX's."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    x, _ = _inputs(ct, 9, b=2, s=9)
    _, cache = JT.prefill(cj, pj, jnp.asarray(x[:, :8]), 16)
    want, _ = JT.decode_step(cj, pj, cache, jnp.asarray(x[:, 8:9]), 8)
    with torch.no_grad():
        _, cache_t = TT.prefill(ct, pt, _port(x[:, :8]), 16)
        got, _ = TT.decode_step(ct, pt, cache_t, _port(x[:, 8:9]), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
