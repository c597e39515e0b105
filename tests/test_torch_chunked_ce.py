"""PyTorch port, the vocab-streaming LM loss and the train step that uses
it, vs the JAX package.

* ``train.loss.chunked_cross_entropy_lm`` against JAX's (its ``lax.scan``
  over vocab chunks, differentiated by ``jax.grad``): tied (V, d) and
  untied (d, V) heads, V a multiple of the chunk and not (the last chunk
  padded at full width with -1e30 logits), one chunk covering V, and
  leading dims (S,), (B, S) and (W, B, S).  Loss rtol 1e-6, the gradients
  of ``hidden`` and ``head`` atol 1e-5 · max|g| (fp32: the two sum the
  chunks' terms in other orders).  Also against the port's full
  ``cross_entropy_lm`` on the materialised logits (loss rtol 1e-6,
  gradients atol 1e-5 · max|g|).
* ``make_train_step(chunked_ce=...)`` against JAX's from the same
  parameters (wq, wk × 0.1, as ``tests/test_torch_train.py``): W=2, k=2,
  VRL-SGD-W rounds of 1, 2, 2, 2; per-step losses rtol 1e-5, final params
  atol 1e-5, Δ atol 1e-5/(k·γ) — the port's trajectory tolerances.  And
  one step's gradients with the chunked loss against the full loss's in
  the port, from one state (atol 1e-5 · max|g| per leaf).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.data import assigned_token_stream as j_stream  # noqa: E402
from repro.data import contiguous_assignment as j_assign  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.loss import chunked_cross_entropy_lm as j_chunked  # noqa
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.train.loss import chunked_cross_entropy_lm as \
    t_chunked  # noqa: E402
from repro_torch.train.loss import cross_entropy_lm as t_ce  # noqa: E402
from repro_torch.train.train_loop import make_train_step as t_make  # noqa

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (leading dims, d, V, chunk, tied)
CE_CASES = [((16,), 32, 512, 128, False), ((16,), 32, 500, 128, True),
            ((3, 9), 16, 300, 64, False), ((3, 9), 16, 256, 64, True),
            ((2, 3, 8), 24, 1000, 256, True), ((2, 3, 8), 24, 777, 100, False),
            ((4, 5), 16, 100, 8192, True)]


def _ce_inputs(lead, d, v, tied, seed, chunk=128):
    rng = np.random.RandomState(seed)
    h = rng.randn(*lead, d).astype(np.float32)
    w = (rng.randn(v, d) if tied else rng.randn(d, v)).astype(np.float32)
    w *= 0.5
    labels = rng.randint(0, v, size=lead).astype(np.int32)
    # labels in the last chunk's first and last real columns
    labels.reshape(-1)[:2] = (v - 1, ((v - 1) // chunk) * chunk)
    return h, w, labels


def _port_grads(h, w, labels, chunk, tied, full=False):
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    lab = torch.from_numpy(labels).long()
    if full:
        loss = t_ce(ht @ (wt.T if tied else wt), lab)
    else:
        loss = t_chunked(ht, wt, lab, chunk=chunk, head_is_embed=tied)
    gh, gw = torch.autograd.grad(loss, (ht, wt))
    return loss.item(), gh.numpy(), gw.numpy()


def _close_grad(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("lead,d,v,chunk,tied", CE_CASES)
def test_chunked_ce_matches_reference(lead, d, v, chunk, tied):
    h, w, labels = _ce_inputs(lead, d, v, tied, seed=v, chunk=chunk)
    lj, (ghj, gwj) = jax.value_and_grad(
        lambda a, b: j_chunked(a, b, jnp.asarray(labels), chunk=chunk,
                               head_is_embed=tied), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    lt, gh, gw = _port_grads(h, w, labels, chunk, tied)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-6)
    _close_grad(gh, np.asarray(ghj), "hidden")
    _close_grad(gw, np.asarray(gwj), "head")


@pytest.mark.parametrize("lead,d,v,chunk,tied", CE_CASES)
def test_chunked_ce_matches_full_cross_entropy(lead, d, v, chunk, tied):
    h, w, labels = _ce_inputs(lead, d, v, tied, seed=v + 1, chunk=chunk)
    lc, ghc, gwc = _port_grads(h, w, labels, chunk, tied)
    lf, ghf, gwf = _port_grads(h, w, labels, chunk, tied, full=True)
    np.testing.assert_allclose(lc, lf, rtol=1e-6)
    _close_grad(ghc, ghf, "hidden")
    _close_grad(gwc, gwf, "head")


def test_chunked_ce_keeps_dtype_and_skips_unwanted_grads():
    """bf16 hidden: the product in fp32 (as the reference's), gradients in
    the inputs' dtypes; a head without grad gets none."""
    h, w, labels = _ce_inputs((2, 8), 16, 300, False, seed=5)
    hb = torch.from_numpy(h).bfloat16().requires_grad_()
    wt = torch.from_numpy(w)
    lab = torch.from_numpy(labels).long()
    loss = t_chunked(hb, wt, lab, chunk=128)
    want = t_chunked(hb.detach().float(), wt, lab, chunk=128)
    assert loss.dtype == torch.float32 and torch.equal(loss, want)
    (gh,) = torch.autograd.grad(loss, (hb,))
    assert gh.dtype == torch.bfloat16 and torch.isfinite(gh).all()


W, B, S, K, LR = 2, 2, 16, 2, 0.05
TRAIN_CASES = [("gemma-7b", 200), ("stablelm-3b", 128)]


@pytest.mark.parametrize("arch,chunk", TRAIN_CASES)
def test_train_step_chunked_ce_matches_reference(arch, chunk):
    """A few rounds of ``make_train_step(chunked_ce=chunk)`` against the
    JAX package's (its xla executor), both free-running from the same
    parameters; the smoke vocab (512) is not a multiple of 200, so the
    last chunk is padded."""
    cj, ct = jreg.smoke_arch(arch), treg.smoke_arch(arch)
    jb = j_make(cj, JVRL(comm_period=K, learning_rate=LR, warmup=True,
                         update_backend="xla"), remat=False,
                chunked_ce=chunk)
    tb = t_make(ct, TVRL(comm_period=K, learning_rate=LR, warmup=True),
                device="cpu", chunked_ce=chunk)
    params = JT.init_params(cj, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    js = jb.engine.init(params, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, params)), W)
    data = j_stream(j_assign(W, W), S, cj.vocab_size, steps=7, batch=B,
                    alpha=0.05, seed=0)
    round_j = jax.jit(jb.round_step)
    t = 0
    for rk in (1, K, K, K):
        toks = data[t:t + rk]
        labels = np.roll(toks, -1, axis=-1)
        js, lj = round_j(js, jnp.asarray(toks), jnp.asarray(labels))
        ts, lt = tb.round_step(ts, torch.from_numpy(toks).long(),
                               torch.from_numpy(labels).long())
        t += rk
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.delta.numpy(), np.asarray(js.delta),
                               rtol=0, atol=1e-5 / (K * LR))


@pytest.mark.parametrize("arch,chunk", TRAIN_CASES)
def test_grads_fn_chunked_equals_full_loss(arch, chunk):
    """One step's gradients (into the flat buffer) and mean loss with the
    chunked loss against the full loss, from one state."""
    ct = treg.smoke_arch(arch)
    vrl = TVRL(comm_period=K, learning_rate=LR)
    full = t_make(ct, vrl, device="cpu", remat=False)
    chunked = t_make(ct, vrl, device="cpu", chunked_ce=chunk)
    state = full.init_state(3, W)
    rng = np.random.RandomState(2)
    toks = torch.from_numpy(rng.randint(0, ct.vocab_size, (W, B, S))).long()
    labels = torch.roll(toks, -1, dims=-1)
    gf, lf = full.grads_fn(state, toks, labels)
    gf = gf.clone()
    gc, lc = chunked.grads_fn(state, toks, labels)
    np.testing.assert_allclose(lc.item(), lf.item(), rtol=1e-6)
    spec = full.engine.spec
    for leaf in spec.leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        a = gf.reshape(W, -1)[:, sl].numpy()
        b = gc.reshape(W, -1)[:, sl].numpy()
        _close_grad(b, a, leaf.path)
