"""PyTorch port, the reference's ``tests/test_models_smoke.py`` over every
ported architecture (the registry's ten, all six families): REDUCED
same-family variants (2 layers, d_model <= 512) run one forward, one train
step and one decode step on the CPU, asserting output shapes and no
NaNs; the reference's prefill-then-decode continuation for each family
(5e-4).  Codec inputs
are drawn frame embeddings (B, S, F), as the reference's test draws them.
No JAX here: the parity with the JAX package is in
``tests/test_torch_model.py``, ``test_torch_backbone.py``,
``test_torch_ssm.py``, ``test_torch_moe.py`` and ``test_torch_hybrid.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import VRLConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

ALL_ARCHS = registry.list_archs()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(cfg, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    if cfg.frontend == "codec":
        return torch.randn((*shape, cfg.frontend_dim), generator=gen)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    with torch.no_grad():
        logits = T.forward(cfg, params, make_inputs(cfg, (2, 32), 1))
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_train_step(arch):
    cfg = registry.smoke_arch(arch)
    vrl = VRLConfig(comm_period=2, learning_rate=0.01, warmup=False)
    bundle = make_train_step(cfg, vrl, remat=False, device="cpu")
    state = bundle.init_state(0, num_workers=2)
    before = state.params.clone()
    tokens = make_inputs(cfg, (2, 2, 32), 1)
    labels = torch.randint(0, cfg.vocab_size, (2, 2, 32),
                           generator=torch.Generator().manual_seed(2))
    new_state, loss = bundle.train_step(state, tokens, labels)
    assert bool(torch.isfinite(loss))
    assert new_state.step == 1
    # params actually moved
    assert (new_state.params - before).abs().max().item() > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_decode_step(arch):
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32)
    with torch.no_grad():
        logits, new_cache = T.decode_step(cfg, params, cache,
                                          make_inputs(cfg, (2, 1), 1), 0)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    # the cache tree (nested for the hybrid) keeps its leaves and shapes
    new, old = tm.leaves_with_path(new_cache), tm.leaves_with_path(cache)
    assert [p for p, _ in new] == [p for p, _ in old]
    for (path, a), (_, b) in zip(new, old):
        assert a.shape == b.shape, path


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-370m",
                                  "stablelm-3b", "musicgen-large",
                                  "hymba-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_prefill_then_decode_continuation(arch):
    """prefill() cache must continue exactly like step-by-step decode."""
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    toks = make_inputs(cfg, (1, 8), 1)
    with torch.no_grad():
        logits_pf, cache_pf = T.prefill(cfg, params, toks, 16)
        cache = T.init_cache(cfg, 1, 16, dtype=torch.float32)
        for i in range(8):
            logits_st, cache = T.decode_step(cfg, params, cache,
                                             toks[:, i:i + 1], i)
        err = (logits_pf[:, -1] - logits_st[:, 0]).abs().max().item()
        assert err < 5e-4, err
        # continue one token (a frame) from both caches: must agree
        nxt = (make_inputs(cfg, (1, 1), 3) if cfg.frontend == "codec"
               else torch.argmax(logits_st[:, -1:], -1))
        l1, _ = T.decode_step(cfg, params, cache_pf, nxt, 8)
        l2, _ = T.decode_step(cfg, params, cache, nxt, 8)
    assert (l1 - l2).abs().max().item() < 5e-4


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_matches_param_defs(arch):
    """Every leaf the defs declare is drawn with its shape, finite."""
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    defs = tm.leaves_with_path(T.model_defs(cfg))
    got = tm.leaves_with_path(params)
    assert [p for p, _ in got] == [p for p, _ in defs]
    for (path, x), (_, d) in zip(got, defs):
        assert tuple(x.shape) == d.shape and torch.isfinite(x).all(), path
