"""PyTorch port, the Mamba2 SSD family (``models.ssm``, the ssm branches of
``models.transformer``, ``configs.mamba2_370m``) and the SSD op
(``kernels.ssd_chunk_scan``, ``kernels/ssd_scan.ssd_scan``) vs the JAX
package, at small size on the CPU.

The JAX side runs as the JAX package's own tests run it: the Pallas
``ssd_scan`` in interpret mode.  On the CPU the port's wrappers run their
plain versions (``ssd_scan_ref``: the Pallas kernel's function, chunk by
chunk), so these tests hold that function and the wrapper's layout steps
(head-major rows, padding, a_log per batch) against the reference.  The
CUDA kernel is held to the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Inputs are drawn with numpy
like the reference tests' (x ~ N(0, 1), dt = softplus(N(0, 1)), a_log ~
0.5 N(0, 1), B, C ~ 0.3 N(0, 1)).

Tolerances: the plain kernel version against interpret-mode Pallas, fp32
atol 1e-5 (the same fp32 function, summed in other orders; the op's cases
at N = 128 and four chunks, 1e-5 · max(1, max|y|)); bf16 one bf16
ulp of the output beyond that (both compute in fp32 and round once; an
output near zero is a cancelling sum whose fp32 error is more than a bf16
ulp there).  Against the
sequential recurrence ``ssd_ref``: the reference's rtol 5e-3 / atol 5e-4
(tests/test_kernel_properties.py).  The model: logits atol 1e-4, as the
dense family's (tests/test_torch_model.py); the cache leaves (the SSM
state reaches ~1e2) atol 1e-4 · max(1, max|leaf|); gradients per leaf
atol 1e-4 · max|g| (the scan's own, where a_log sums over every step and
cum falls by hundreds: 1e-3 · max|g|, as tests/test_torch_model.py).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.train.loss import cross_entropy_lm as j_ce  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.train.loss import cross_entropy_lm as t_ce  # noqa: E402
from repro_torch.train.train_loop import make_train_step as t_make  # noqa: E402

ARCH = "mamba2-370m"
CFG_J, CFG_T = jreg.smoke_arch(ARCH), treg.smoke_arch(ARCH)
LOGIT_TOL = 1e-4
# mamba2-370m's materialised parameters (jax.eval_shape of the reference's
# init_params gives the same); the analytic param_count is the reference's
MATERIALISED = 368_227_840


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(seed, b, l, h, p, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, l, h))).astype(np.float32)
    a_log = (rng.randn(h) * 0.5).astype(np.float32)
    bb = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    cc = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    return x, dt, a_log, bb, cc


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _head_major(x, dt, a_log, b):
    """The (BH, L, P) kernel layout of (B, L, H, P) draws."""
    bsz, l, h, p = x.shape
    return (np.ascontiguousarray(np.moveaxis(x, 2, 1)).reshape(bsz * h, l, p),
            np.ascontiguousarray(np.moveaxis(dt, 2, 1)).reshape(bsz * h, l),
            np.tile(a_log[None], (bsz, 1)).reshape(bsz * h, 1))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), for bf16 values in fp32."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), np.maximum(e, -125) - 8)


def assert_kernel_close(got: torch.Tensor, want, dtype: str,
                        scaled: bool = False):
    """fp32 atol 1e-5 (× max(1, max|want|) where ``scaled``); bf16 one bf16
    ulp beyond that."""
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    bound = 1e-5 * (max(1.0, np.abs(want).max()) if scaled else 1.0)
    if dtype == "bfloat16":
        bound = bound + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (err <= bound).all(), err.max()


# ------------------------------------------------ (a) the kernel's function
SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
          (1, 256, 1, 64, 128, 64)]   # tests/test_kernels.py's three


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_scan_matches_interpret_pallas(shape, dtype):
    b, l, h, p, n, q = shape
    x, dt, a_log, bb, cc = _draws(l + h, b, l, h, p, n)
    xt, dtt, alt = _head_major(x, dt, a_log, bb)
    want = j_ssd_scan(*_j(xt, dtt, dtype=dtype), jnp.asarray(alt),
                      *_j(bb, cc, dtype=dtype), chunk=q, num_heads=h,
                      interpret=True)
    tdt = getattr(torch, dtype)
    got = tss.ssd_scan(*_t(xt, dtt, dtype=tdt), torch.from_numpy(alt),
                       *_t(bb, cc, dtype=tdt), chunk=q, num_heads=h)
    assert got.dtype == tdt
    assert_kernel_close(got, want, dtype)


def test_ssd_scan_keeps_the_reference_asserts():
    x, dt, a_log, bb, cc = _draws(0, 1, 48, 2, 8, 4)
    xt, dtt, alt = _head_major(x, dt, a_log, bb)
    with pytest.raises(AssertionError):
        tss.ssd_scan(*_t(xt, dtt), torch.from_numpy(alt), *_t(bb, cc),
                     chunk=32, num_heads=2)
    with pytest.raises(ValueError):          # B·H rows for 3 heads: no
        tss.ssd_scan(*_t(xt, dtt), torch.from_numpy(alt), *_t(bb, cc),
                     chunk=16, num_heads=3)


# ------------------------------------------------------------- (b) the op
OP_CASES = [
    # b, l, h, p, n, chunk: no padding; ragged L padded to the chunk; a
    # chunk larger than L (chunk = L); several chunks and a short last one
    (2, 128, 4, 32, 16, 32),
    (2, 100, 3, 16, 8, 32),
    (1, 37, 2, 8, 4, 256),
    (1, 200, 2, 64, 128, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", OP_CASES)
def test_ssd_chunk_scan_matches_reference_op(case, dtype):
    b, l, h, p, n, q = case
    x, dt, a_log, bb, cc = _draws(l * h + p, b, l, h, p, n)
    want = jops.ssd_chunk_scan(*_j(x, dt, dtype=dtype), jnp.asarray(a_log),
                               *_j(bb, cc, dtype=dtype), chunk=q,
                               interpret=True)
    tdt = getattr(torch, dtype)
    got = tkernels.ssd_chunk_scan(*_t(x, dt, dtype=tdt),
                                  torch.from_numpy(a_log),
                                  *_t(bb, cc, dtype=tdt), chunk=q)
    assert tuple(got.shape) == (b, l, h, p) and got.dtype == tdt
    assert_kernel_close(got, want, dtype, scaled=True)


@pytest.mark.parametrize("dtypes", [
    ("bfloat16", "float32", "float32", "float32"),
    ("float32", "bfloat16", "bfloat16", "bfloat16"),
    ("bfloat16", "float32", "bfloat16", "bfloat16"),
    ("float32", "float32", "bfloat16", "float32")])
def test_ssd_chunk_scan_mixed_dtypes_match_reference_op(dtypes):
    """x, dt, B and C in mixed dtypes: a bf16 x with fp32 dt, B and C, the
    reverse, Mamba2's usual bf16 x, B, C with an fp32 dt, and B and C
    apart; each input is read up to fp32, y is in x's dtype."""
    b, l, h, p, n, q = 2, 100, 3, 16, 8, 32
    x, dt, a_log, bb, cc = _draws(11, b, l, h, p, n)
    arrays = (x, dt, bb, cc)
    jx, jdt, jb, jc = (_j(a, dtype=d)[0] for a, d in zip(arrays, dtypes))
    want = jops.ssd_chunk_scan(jx, jdt, jnp.asarray(a_log), jb, jc,
                               chunk=q, interpret=True)
    tx, tdt, tb, tc = (_t(a, dtype=getattr(torch, d))[0]
                       for a, d in zip(arrays, dtypes))
    got = tkernels.ssd_chunk_scan(tx, tdt, torch.from_numpy(a_log), tb, tc,
                                  chunk=q)
    assert got.dtype == tx.dtype and want.dtype == jnp.dtype(dtypes[0])
    assert_kernel_close(got, want, dtypes[0], scaled=True)


def test_ssd_chunk_scan_on_the_cpu_launches_nothing():
    x, dt, a_log, bb, cc = _draws(1, 1, 40, 2, 8, 4)
    n0 = tss.LAUNCHES["ssd_scan"]
    tkernels.ssd_chunk_scan(*_t(x, dt), torch.from_numpy(a_log),
                            *_t(bb, cc), chunk=16)
    assert tss.LAUNCHES["ssd_scan"] == n0


# ------------------------------------------------- (c) the recurrence oracle
REF_CASES = [(b, nc, h, p, n, seed) for seed, (b, nc, h, p, n) in enumerate(
    [(1, 1, 1, 8, 4), (2, 3, 2, 16, 8), (1, 4, 3, 8, 8), (2, 2, 3, 16, 4)])]


@pytest.mark.parametrize("case", REF_CASES)
def test_plain_versions_match_the_recurrence(case):
    """tests/test_kernel_properties.py's check on the port: chunked (the
    op, and the model's ssd_chunked) == the sequential recurrence; and
    the port's ssd_ref is the reference's."""
    b, nc, h, p, n, seed = case
    chunk = 16
    l = nc * chunk
    x, dt, a_log, bb, cc = _draws(seed, b, l, h, p, n)
    ref = tss.ssd_ref(*_t(x, dt, a_log, bb, cc)).numpy()
    np.testing.assert_allclose(
        ref, np.asarray(j_ssd_ref(*_j(x, dt, a_log, bb, cc))), rtol=1e-5,
        atol=1e-6)
    for y in (tkernels.ssd_chunk_scan(*_t(x, dt, a_log, bb, cc),
                                      chunk=chunk),
              TS.ssd_chunked(*_t(x, dt, a_log, bb, cc), chunk)):
        np.testing.assert_allclose(y.numpy(), ref, rtol=5e-3, atol=5e-4)


# ------------------------------------------------ (d) the model's scan
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_reference(with_state, return_state):
    b, l, h, p, n, q = 2, 96, 3, 16, 8, 32
    x, dt, a_log, bb, cc = _draws(11, b, l, h, p, n)
    s0 = (np.random.RandomState(12).randn(b, h, p, n).astype(np.float32)
          if with_state else None)
    want = JS.ssd_chunked(*_j(x, dt, a_log, bb, cc), q,
                          state_in=None if s0 is None else jnp.asarray(s0),
                          return_state=return_state)
    got = TS.ssd_chunked(*_t(x, dt, a_log, bb, cc), q,
                         state_in=None if s0 is None
                         else torch.from_numpy(s0),
                         return_state=return_state)
    if return_state:
        (want, wstate), (got, gstate) = want, got
        np.testing.assert_allclose(gstate.numpy(), np.asarray(wstate),
                                   rtol=0, atol=1e-5 * max(
                                       1.0, np.abs(np.asarray(wstate)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # and the op (the Pallas kernel's function) without a carried state
    if not with_state:
        op = tkernels.ssd_chunk_scan(*_t(x, dt, a_log, bb, cc), chunk=q)
        np.testing.assert_allclose(op.numpy(), got.numpy(), rtol=0,
                                   atol=1e-4)


def test_ssd_chunked_gradients_are_finite_and_match_reference():
    """The masked exp(where(mask, seg, -1e30)) keeps the gradients finite
    even where cum falls by hundreds in a chunk (a_log = 2)."""
    b, l, h, p, n, q = 1, 48, 2, 8, 4, 48
    x, dt, _, bb, cc = _draws(13, b, l, h, p, n)
    a_log = np.full((h,), 2.0, np.float32)

    def jloss(*args):
        return jnp.sum(JS.ssd_chunked(*args, q) ** 2)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *_j(x, dt, a_log, bb, cc))
    args = [t.requires_grad_() for t in _t(x, dt, a_log, bb, cc)]
    gt = torch.autograd.grad(
        torch.sum(TS.ssd_chunked(*args, q) ** 2), args)
    for a, g in zip(gj, gt):
        a = np.asarray(a)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=1e-3 * np.abs(a).max())


# ------------------------------------------- (e) the smoke model, end to end
@pytest.fixture(scope="module")
def params():
    pj = JT.init_params(CFG_J, jax.random.PRNGKey(0))
    return pj, from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(seed, b=2, s=40):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CFG_T.vocab_size, size=(b, s)).astype(np.int32)


def _assert_cache(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(jnp.asarray(want[key]).astype(jnp.float32))
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == str(want[key].dtype), key
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=key)


def test_param_tree_matches_reference(params):
    pj, pt = params
    jpaths = [("/".join(str(k.key) for k in path), tuple(x.shape))
              for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]]
    tpaths = [(path, tuple(x.shape)) for path, x in tm.leaves_with_path(pt)]
    assert tpaths == jpaths
    fresh = TT.init_params(CFG_T, seed=0)
    defs = tm.leaves(TT.model_defs(CFG_T))
    for (path, a), (_, b), d in zip(tm.leaves_with_path(fresh),
                                    tm.leaves_with_path(pt), defs):
        if d.init == "zeros":           # A_log, dt_bias
            assert not a.any() and not b.any(), path
        elif d.init == "ones":          # D, the norms
            assert torch.all(a == 1) and torch.all(b == 1), path
        else:       # normal: the def's scale (conv_* 0.5) or 1/sqrt(fan-in)
            std = d.scale if d.scale is not None else d.shape[-2] ** -0.5
            for x in (a, b):            # ≥ 128 draws: within 4 sigma
                assert abs(x.std().item() / std - 1) < 0.25, path


@pytest.mark.parametrize("s", [16, 40, 64])
def test_logits_match_reference(params, s):
    """One chunk (16 < 32: chunk = L), a padded second chunk, two chunks."""
    pj, pt = params
    toks = _tokens(s, s=s)
    want, _ = JT.forward(CFG_J, pj, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(CFG_T, pt, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, s, CFG_T.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_loss_and_grads_match_reference(params):
    pj, pt = params
    toks = _tokens(2)
    labels = np.roll(toks, -1, axis=-1)

    def jloss(p):
        logits, _ = JT.forward(CFG_J, p, jnp.asarray(toks))
        return j_ce(logits, jnp.asarray(labels))

    lj, gj = jax.jit(jax.value_and_grad(jloss))(pj)
    pairs = tm.leaves_with_path(pt)
    leaves = [x.clone().requires_grad_() for _, x in pairs]
    p = tm.from_paths([(path, x) for (path, _), x in zip(pairs, leaves)])
    lt = t_ce(TT.forward(CFG_T, p, torch.from_numpy(toks).long()),
              torch.from_numpy(labels).long())
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    gj_leaves = jax.tree.leaves(gj)
    assert len(gj_leaves) == len(gt)
    for (path, _), a, b in zip(pairs, gj_leaves, gt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max() + 1e-12,
                                   err_msg=path)


@pytest.mark.parametrize("s", [2, 40])
def test_prefill_logits_and_cache_match_reference(params, s):
    """A prompt shorter than the conv window (left-padded) and one past a
    chunk (the final state carried over the padded chunk)."""
    pj, pt = params
    toks = _tokens(s + 1, s=s)
    lj, cj = JT.prefill(CFG_J, pj, jnp.asarray(toks), 64)
    with torch.no_grad():
        lt, ct = TT.prefill(CFG_T, pt, torch.from_numpy(toks).long(), 64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    _assert_cache(ct, cj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_cache_and_decode_match_reference(params, dtype):
    """init_cache (state fp32, conv window in the cache dtype) and
    teacher-forced decode from it: the bf16 window is promoted against the
    fp32 conv weights, as jnp promotes it."""
    pj, pt = params
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cj = JT.init_cache(CFG_J, 2, 16, dtype=jdt)
    ct = TT.init_cache(CFG_T, 2, 16, dtype=dtype)
    _assert_cache(ct, cj)
    toks = _tokens(21, s=6)
    step = jax.jit(lambda c, t: JT.decode_step(CFG_J, pj, c, t, 0))
    with torch.no_grad():
        for i in range(6):
            lj, cj = step(cj, jnp.asarray(toks[:, i:i + 1]))
            lt, ct = TT.decode_step(CFG_T, pt, ct,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    i)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                       atol=LOGIT_TOL)
    _assert_cache(ct, cj)


def test_prefill_then_decode_continuation(params):
    """The reference's test_models_smoke.py:70 on the port: prefill's cache
    continues exactly like step-by-step decode."""
    _, pt = params
    toks = torch.from_numpy(_tokens(7, b=1, s=8)).long()
    with torch.no_grad():
        logits_pf, cache_pf = TT.prefill(CFG_T, pt, toks, 16)
        cache = TT.init_cache(CFG_T, 1, 16, dtype=torch.float32)
        for i in range(8):
            logits_st, cache = TT.decode_step(CFG_T, pt, cache,
                                              toks[:, i:i + 1], i)
        err = (logits_pf[:, -1] - logits_st[:, 0]).abs().max().item()
        assert err < 5e-4, err
        nxt = torch.argmax(logits_st[:, -1:], -1)
        l1, _ = TT.decode_step(CFG_T, pt, cache_pf, nxt, 8)
        l2, _ = TT.decode_step(CFG_T, pt, cache, nxt, 8)
    assert (l1 - l2).abs().max().item() < 5e-4


def test_engine_greedy_matches_reference(params):
    """serve.Engine's greedy tokens against the reference's, wherever the
    reference's top-2 margin exceeds twice the logits tolerance (below it
    either pick is right and the two runs may part)."""
    pj, pt = params
    prompt = _tokens(9, b=3, s=36)
    want = np.asarray(JEngine(CFG_J, pj, max_len=48)
                      .generate(jnp.asarray(prompt), 12))
    got = TEngine(CFG_T, pt, max_len=48).generate(
        torch.from_numpy(prompt).long(), 12).numpy()
    assert got.shape == want.shape == (3, 48)
    np.testing.assert_array_equal(got[:, :36], prompt)
    logits, cache = JT.prefill(CFG_J, pj, jnp.asarray(want[:, :36]), 48,
                               last_only=True)
    step = jax.jit(lambda c, t: JT.decode_step(CFG_J, pj, c, t, 0))
    compared = 0
    for i in range(12):
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        for row in np.nonzero(top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL)[0]:
            if (got[row, 36:36 + i] == want[row, 36:36 + i]).all():
                assert got[row, 36 + i] == want[row, 36 + i], (row, i)
                compared += 1
        if i < 11:
            logits, cache = step(cache, jnp.asarray(want[:, 36 + i:37 + i]))
    assert compared >= 12


W, B, S, K, LR = 2, 2, 40, 2, 0.05


def test_vrl_sgd_trajectory_matches_reference(params):
    """vrl_sgd + sgd on the flat engine, W = 2, k = 2 with warmup (rounds
    of 1, 2, 2, 2), seq 40 (a padded second chunk), both free-running from
    the same parameters: per-step losses rtol 1e-5, final params atol 1e-5,
    Δ atol 1e-5/(k·γ) (the reference's engine standard)."""
    pj, _ = params
    jb = j_make(CFG_J, JVRL(comm_period=K, learning_rate=LR, warmup=True,
                            update_backend="xla"), remat=False)
    tb = t_make(CFG_T, TVRL(comm_period=K, learning_rate=LR, warmup=True),
                device="cpu")
    js = jb.engine.init(pj, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, pj)), W)
    data = j_stream(j_assign(W, W), S, CFG_J.vocab_size, steps=7, batch=B,
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
        assert (ts.step, ts.last_sync) == (int(js.step), int(js.last_sync))
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.delta.numpy(), np.asarray(js.delta),
                               rtol=0, atol=1e-5 / (K * LR))


# ------------------------------------------- (f) configs and param counts
def test_config_and_param_count_match_reference():
    assert ARCH in treg.list_archs()
    assert jreg.get_arch(ARCH).__dict__ == treg.get_arch(ARCH).__dict__
    assert CFG_J.__dict__ == CFG_T.__dict__
    for cj, ct in ((jreg.get_arch(ARCH), treg.get_arch(ARCH)),
                   (CFG_J, CFG_T)):
        assert cj.param_count() == ct.param_count()
        for prop in ("ssm_d_inner", "ssm_num_heads", "is_attention_free",
                     "subquadratic"):
            assert getattr(cj, prop) == getattr(ct, prop), prop
    cfg = treg.get_arch(ARCH)
    assert (cfg.ssm_d_inner, cfg.ssm_num_heads) == (2048, 32)
    assert cfg.is_attention_free and cfg.subquadratic
    # the reference's analytic count (B/C per head, two norms per layer)
    # against the tree the model materialises, counted on meta tensors
    assert cfg.param_count() == 759_767_040
    n = sum(x.numel() for x in tm.leaves(tparam.abstract(TT.model_defs(cfg))))
    assert n == MATERIALISED
    smoke = sum(x.numel() for x in tm.leaves(tparam.abstract(
        TT.model_defs(CFG_T))))
    assert smoke == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: JT.init_params(CFG_J, jax.random.PRNGKey(0)))))


# ---------------------------------------------------------------- the CLIs
def test_launch_train_and_serve_run_mamba2_on_cpu(capsys):
    res = tlaunch.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--workers", "2", "--steps", "3", "--k", "2",
                       "--batch", "1", "--seq", "40", "--lr", "0.05",
                       "--warmup"])
    assert len(res.losses) == 3 and np.all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "mamba2-370m [ssm]" in out and "max|sum_i delta_i|" in out
    sres = tserve.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "36", "--gen", "5"])
    assert tuple(sres.out.shape) == (2, 41)
    assert torch.equal(sres.out[:, :36], sres.prompt)
    assert 0 <= int(sres.out.min()) and int(sres.out.max()) < CFG_T.vocab_size
    assert "ms per token" in capsys.readouterr().out
