"""PyTorch port at the reference's parameter dtypes: bf16 parameters (and a
bf16 or fp32 Δ) through the flat engine's kernels, the engines, the
per-leaf executor and the train step, against the JAX package on the CPU.

  (a) Each flat plain version (``kernels/torch_update``) at bf16 p and g,
      with an fp32 and a bf16 Δ/B, is bitwise the JAX package's
      ``xla_update`` twin.  Against the Pallas kernel in interpret mode:
      bitwise where interpret mode contracts nothing (the syncs, the EF
      round trips); elsewhere interpret mode contracts a·b + c into one FMA
      (``tests/test_torch_update.py``), which can move a bf16 rounding: each
      bf16 output within one bf16 ulp, at most 1 % of its elements apart,
      each fp32 output within the FMA's skipped roundings.
  (b) The flat engine (every flat algorithm × sgd, momentum, Adam, Adam +
      SM3; hier_vrl_sgd (2, 2) with each inner optimizer; overlap; int8 EF)
      over two rounds of identical bf16 gradients, against the JAX
      package's ``xla`` engine run op by op (``jax.disable_jit``): bitwise,
      every state buffer.  Under ``jit`` XLA's CPU backend contracts
      a·b + c into FMAs, which moves single roundings: the jitted engine
      is held to one bf16 ulp of p on at most 1e-3 of the elements.  int8
      EF is held to eager ``repro.comm.compressors`` as
      ``tests/test_torch_compress.py`` holds it (flipped int8 levels).
  (c) The per-leaf executor (``update_backend="reference"``) at bf16
      against the JAX package's per-leaf executor, op by op: bitwise.
  (d) ``make_train_step(param_dtype=torch.bfloat16)`` on the smoke qwen2
      from the JAX package's bf16 parameters: bf16 gradients and states;
      one step's loss within 1e-2 relative of JAX's, each gradient leaf
      within 2^-5 · max|g| of JAX's.
  (e) On the card (``cuda``-marked, skipped without one): each kernel at
      bf16 p and g, fp32 and bf16 Δ, bitwise its plain version, NaN for
      NaN.  No JAX there: the JAX-side tests skip without the package.

Inputs are drawn with numpy from fixed seeds; one torch thread.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import vrl_update as jvu
    from repro.kernels import xla_update as jxu
except ImportError:        # the card's machine: only (e) runs there
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is the "
                               "oracle of the CPU tests")

W, R, C = 3, 16, 256
GRID = (2, 2)
BLOCK = 8
LR = 0.05
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the kernel cases
# kernel -> (positional operands, keyword operands, options, in-place
# operand positions); operands by role: p, g, x̂ take the parameters'
# dtype, d/b/d1/d2 the drift dtype, m/mu/nu the moments', the rest fp32
KERNELS = {
    "fused_local_sgd": (["p", "g", "d"], ["b"], dict(lr=LR, wd=1e-4), (0,)),
    "fused_local_momentum": (["p", "g", "d", "m"], ["b"],
                             dict(lr=LR, beta=0.9, wd=1e-4), (0, 3)),
    "fused_local_adam": (["p", "g", "d", "mu", "nu", "scal2"], ["b"],
                         dict(lr=1e-3, wd=1e-4), (0, 3, 4)),
    "fused_local_adam_sm3": (["p", "g", "d", "mu", "row", "col", "scal2"],
                             ["b"], dict(lr=1e-3, wd=1e-4), (0, 3, 4)),
    "fused_sync_vrl": (["p", "xbar", "d", "scal1"], [], {}, (0, 2)),
    "fused_sync_bvr": (["p", "xbar", "d", "b", "scal1"], [],
                       dict(beta=0.5), (0, 2, 3)),
    "fused_sync_easgd": (["p", "xbar32", "center"], [],
                         dict(a=0.3 / W, na=0.3), (0, 2)),
    "fused_ef_int8": (["p", "ref", "e"], [], {}, (2,)),
    "fused_ef_topk": (["p", "ref", "e"], [], dict(k=8), (2,)),
    "fused_fold_overlap": (["p", "xbar", "pend", "d", "wscal"], [],
                           dict(capture=True), (0, 2, 3)),
    "fused_fold_overlap_bvr": (["p", "xbar", "pend", "d", "b", "wscal"], [],
                               dict(beta=0.5, capture=True), (0, 2, 3, 4)),
    "fused_fold_overlap_avg": (["p", "xbar", "pend", "wscal"], [],
                               dict(capture=True), (0, 2)),
    "fused_hier_local_sgd": (["p", "g", "d1", "d2"], [],
                             dict(lr=LR, wd=1e-4), (0,)),
    "fused_hier_local_momentum": (["p", "g", "d1", "d2", "m"], [],
                                  dict(lr=LR, beta=0.9, wd=1e-4,
                                       nesterov=True), (0, 4)),
    "fused_hier_local_adam": (["p", "g", "d1", "d2", "mu", "nu", "scal2"],
                              [], dict(lr=1e-3, wd=1e-4), (0, 4, 5)),
    "fused_hier_local_adam_sm3": (["p", "g", "d1", "d2", "mu", "row", "col",
                                   "scal2"], [], dict(lr=1e-3, wd=1e-4),
                                  (0, 4, 5)),
    "fused_sync_hier1": (["p", "xbar_pod", "d1", "scal1"], [], {}, (0, 2)),
    "fused_sync_hier2": (["p", "glob", "d2", "scal1"], [], {}, (0, 2)),
    "fused_fold_overlap_hier2": (["p", "glob", "pend2", "d2", "wscal"], [],
                                 dict(capture=True), (0, 2, 3)),
    "fused_ef_int8_grid": (["p", "ref_pod", "e"], [], {}, (2,)),
    "fused_ef_topk_grid": (["p", "ref_pod", "e"], [], dict(k=8), (2,)),
}
HIER = {k for k in KERNELS if "hier" in k or k.endswith("_grid")}
PARAMS = {"p", "g", "xbar", "xbar_pod", "glob"}
DRIFT = {"d", "b", "d1", "d2"}
MOMENTS = {"m", "mu", "nu"}
# the moments' dtype by kernel: one bf16 case beside the fp32 ones
MOMENT_DT = {"fused_local_momentum": "bf16", "fused_hier_local_adam_sm3":
             "bf16"}


def _arrays(name: str, seed: int, r: int = R) -> dict:
    """Every operand ``name`` reads, as fp32 numpy arrays (before the
    dtype casts): unit-scale parameters and gradients, small Δ, moments,
    EF residuals and the stale mean's offset."""
    rng = np.random.RandomState(seed)
    hier = name in HIER
    lead = GRID if hier else (W,)
    pods = (GRID[0], 1) if hier else ()
    nw = int(np.prod(lead))

    def rn(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)
    p = rn(*lead, r, C)
    if name in ("fused_sync_hier2", "fused_fold_overlap_hier2"):
        # their contract: a level-1 sync at the same step, so every worker
        # of a pod holds the pod's value
        p = np.repeat(p[:, :1], GRID[1], axis=1)
    a = {"p": p, "g": rn(*lead, r, C), "d": rn(*lead, r, C, s=0.1),
         "b": rn(*lead, r, C, s=0.1), "d1": rn(*lead, r, C, s=0.1),
         "d2": rn(*pods, r, C, s=0.1), "m": rn(*lead, r, C, s=0.1),
         "mu": rn(*lead, r, C, s=0.1),
         "nu": np.square(rn(*lead, r, C, s=0.1)),
         "row": np.square(rn(*lead, r, 1, s=0.1)),
         "col": np.square(rn(*lead, 2, C, s=0.1)),
         "xbar": p.reshape(-1, r, C).mean(0) + rn(r, C, s=0.01),
         "xbar32": p.reshape(-1, r, C).mean(0) + rn(r, C, s=0.01),
         "xbar_pod": p.mean(1, keepdims=True) + rn(*pods, r, C, s=0.01),
         "glob": rn(r, C), "center": rn(r, C),
         "ref": rn(r, C, s=0.5), "ref_pod": rn(*pods, r, C, s=0.5),
         "e": rn(*lead, r, C, s=0.01),
         "pend": p + rn(*lead, r, C, s=0.01),
         "pend2": rn(*pods, r, C),
         "scal1": np.array([[3 * LR]], np.float32),
         "scal2": np.array([[1 - 0.9 ** 3, 1 - 0.999 ** 3]], np.float32)}
    npart = GRID[0] if name == "fused_fold_overlap_hier2" else nw
    pend_k = np.array([1.0, 2.0, 3.0, 2.0][:npart], np.float32)
    km = np.array([0.0, 1.0, 0.0, 1.0][:npart], np.float32)
    a["wscal"] = np.stack([np.float32(1) / (pend_k * np.float32(LR)), km],
                          axis=1).astype(np.float32)
    return a


def _dtype(key: str, name: str, pdt: str, ddt: str) -> str:
    if key in PARAMS:
        return pdt
    if key in DRIFT:
        return ddt
    if key in MOMENTS:
        return MOMENT_DT.get(name, "f32")
    return "f32"


def _torch_args(name, pdt, ddt, seed=0, device="cpu", r=R):
    """(args, kwargs, options) of ``name`` as torch tensors on ``device``."""
    pos, kws, opts, _ = KERNELS[name]
    a = _arrays(name, seed, r)

    def t(key):
        return torch.from_numpy(a[key]).to(device).to(
            TDT[_dtype(key, name, pdt, ddt)])
    return [t(k) for k in pos], {k: t(k) for k in kws}, dict(opts)


def _jax_args(name, pdt, ddt, seed=0):
    pos, kws, opts, _ = KERNELS[name]
    a = _arrays(name, seed)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}

    def j(key):
        return jnp.asarray(a[key]).astype(jdt[_dtype(key, name, pdt, ddt)])
    return [j(k) for k in pos], {k: j(k) for k in kws}, dict(opts)


def _outs(x) -> list:
    xs = x if isinstance(x, (tuple, list)) else (x,)
    return [None if y is None else y for y in xs]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bitwise(got, want, what):
    got, want = _outs(got), _outs(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, (what, i)
            continue
        assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1], (
            what, i, a.dtype, b.dtype)
        x, y = _np(a), _np(b)
        nan = np.isnan(x)
        assert np.array_equal(nan, np.isnan(y)), (what, i)
        assert np.array_equal(x[~nan], y[~nan]), (
            what, i, int((x != y).sum()), float(np.nanmax(np.abs(x - y))))


CASES = [(k, ddt) for k in KERNELS for ddt in ("f32", "bf16")]


# ------------------------------------ (a) plain versions against the JAX
@needs_jax
@pytest.mark.parametrize("name,ddt", CASES)
def test_plain_bf16_bitwise_xla_twin(name, ddt):
    args, kw, opts = _torch_args(name, "bf16", ddt)
    jargs, jkw, _ = _jax_args(name, "bf16", ddt)
    got = getattr(tu, name)(*args, **kw, **opts)
    want = getattr(jxu, name)(*jargs, **jkw, **opts)
    _bitwise(got, want, name)
    assert _outs(got)[0].dtype == (torch.float32 if "_ef_" in name
                                   else torch.bfloat16)


# interpret-mode Pallas contracts nothing in these (products that feed no
# add, or none at all): bitwise.  The int8 round trips are not in it: the
# JAX package's own two int8 executors part by an fp32 ulp (ROADMAP
# Queue 3), and so does the plain version from the Pallas kernel
PALLAS_EXACT = {"fused_sync_vrl", "fused_sync_bvr", "fused_sync_hier1",
                "fused_sync_hier2", "fused_ef_topk", "fused_ef_topk_grid"}


@needs_jax
@pytest.mark.parametrize("name,ddt", CASES)
def test_plain_bf16_vs_pallas_interpret(name, ddt):
    args, kw, opts = _torch_args(name, "bf16", ddt)
    jargs, jkw, _ = _jax_args(name, "bf16", ddt)
    got = getattr(tu, name)(*args, **kw, **opts)
    want = getattr(jvu, name)(*jargs, **jkw, **opts, block=BLOCK,
                              interpret=True)
    if name in PALLAS_EXACT:
        _bitwise(got, want, name)
        return
    if "_ef_" in name:
        # dec = level · scale, resid' = payload − dec: both within the
        # rounding of a scale one ulp apart, no int8 level flipped
        dec, res = _np(got[0]), _np(got[1])
        tol = 2 * np.spacing(np.abs(_np(want[0])))
        assert np.all(np.abs(dec - _np(want[0])) <= tol), name
        assert np.all(np.abs(res - _np(want[1])) <= tol), name
        return
    for a, b in zip(_outs(got), _outs(want)):
        x, y = _np(a), _np(b)
        if a.dtype == torch.bfloat16:
            # one rounding moved: at most one bf16 ulp, on few elements
            ulp = np.spacing(np.abs(y).astype(np.float32)) * 2.0 ** 16
            assert np.all(np.abs(x - y) <= ulp), name
            assert (x != y).mean() <= 0.01, (name, (x != y).mean())
        else:
            # the skipped roundings of a few fp32 products and sums
            tol = 8 * np.spacing(np.maximum(np.abs(y), np.abs(x))) + 1e-30
            scale = np.max(np.abs(y))
            assert np.all(np.abs(x - y) <= tol + 2.0 ** -22 * scale), name


# ------------------------------------------------ (b) the engine against JAX
EW, EK = 4, 3
FLAT_ALGS = ("vrl_sgd", "local_sgd", "ssgd", "easgd", "stl_sgd",
             "bvr_l_sgd")
INNERS = {"sgd": {}, "momentum": dict(inner_optimizer="momentum",
                                      momentum=0.9),
          "adam": dict(inner_optimizer="adam"),
          "adam_sm3": dict(inner_optimizer="adam", sm3=True)}


@functools.lru_cache(maxsize=None)
def _smoke():
    """The smoke qwen2's bf16 template in both packages and its bf16
    parameters from the JAX package (the port takes the same bits)."""
    from repro.configs import registry as jreg
    from repro.models import transformer as JT
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as TT
    from repro_torch.models.param import abstract
    cfg = jreg.smoke_arch("qwen2-0.5b")
    tj = jax.eval_shape(functools.partial(JT.init_params, cfg,
                                          dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    tt = abstract(TT.model_defs(treg.smoke_arch("qwen2-0.5b")),
                  torch.bfloat16)
    pj = JT.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    return tj, tt, pj


def _to_torch(x):
    """A JAX array as a torch tensor of its dtype (bf16 through fp32,
    exact), a copy the engine may write."""
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _cfgs(alg, inner="sgd", ddt="float32", compress=None, backend="xla",
          **over):
    from repro.comm import compressors as jcc
    from repro.configs.base import HierConfig as JHier
    from repro.configs.base import VRLConfig as JVRL
    from repro_torch.comm import compressors as tcc
    from repro_torch.configs.base import HierConfig as THier
    from repro_torch.configs.base import VRLConfig as TVRL
    kw = dict(dict(algorithm=alg, comm_period=EK, learning_rate=LR,
                   weight_decay=1e-3, delta_dtype=ddt, warmup=False,
                   **INNERS[inner]), **over)
    cj = dict(kw, compress=compress and jcc.parse_compressor(compress))
    ct = dict(kw, compress=compress and tcc.parse_compressor(compress))
    if alg == "hier_vrl_sgd":
        cj["hier"] = JHier(k1=EK, k2=2 * EK, grid=GRID)
        ct["hier"] = THier(k1=EK, k2=2 * EK, grid=GRID)
    return (JVRL(update_backend=backend, **cj),
            TVRL(update_backend=backend, **ct))


def _leaves(state, prefix=""):
    """{path: tensor or array} of a state's buffers (host ints skipped)."""
    out = {}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        for f in state._fields:
            out.update(_leaves(getattr(state, f), f"{prefix}{f}/"))
    elif hasattr(state, "shape") and getattr(state, "ndim", 0) > 0:
        out[prefix.rstrip("/")] = state
    return out


def _rounds(alg, inner="sgd", ddt="float32", compress=None, rounds=2,
            eager=True, **over):
    """Both engines from the same bf16 parameters over ``rounds`` rounds of
    the same bf16 gradients; the JAX one op by op (``eager``) or jitted.
    Returns the two final states."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    tj, tt, pj = _smoke()
    cj, ct = _cfgs(alg, inner, ddt, compress, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    assert et.spec.meta() == ej.spec.meta()
    lead = GRID if alg == "hier_vrl_sgd" else (EW,)
    sj = ej.init(pj, EW)
    st = et.init(jax.tree.map(_to_torch, pj), EW)
    assert st.params.dtype == torch.bfloat16
    step = ej.round_step_flat if eager else jax.jit(ej.round_step_flat)
    rng = np.random.RandomState(7)
    ctx = jax.disable_jit() if eager else contextlib.nullcontext()
    with ctx:
        for _ in range(rounds):
            g = np.zeros((EK, *lead, ej.spec.rows, ej.spec.lanes),
                         np.float32)
            g.reshape(EK, *lead, -1)[..., :ej.spec.size] = rng.randn(
                EK, *lead, ej.spec.size)
            sj = step(sj, jnp.asarray(g).astype(jnp.bfloat16))
            st = et.round_step_flat(st, torch.from_numpy(g).to(
                torch.bfloat16))
    return sj, st


def _assert_states_bitwise(sj, st, what):
    lj, lt = _leaves(sj), _leaves(st)
    assert set(lt) == set(lj) - {"inner/count"}, (what, set(lj) ^ set(lt))
    for k, t in lt.items():
        _bitwise(t, lj[k], (what, k))


ENGINE_CASES = ([(a, i, d) for a in FLAT_ALGS for i in INNERS
                 for d in ("float32", "bfloat16")]
                + [("hier_vrl_sgd", i, d) for i in INNERS
                   for d in ("float32", "bfloat16")])


@needs_jax
@pytest.mark.parametrize("alg,inner,ddt", ENGINE_CASES)
def test_engine_bf16_bitwise_reference_op_by_op(alg, inner, ddt):
    sj, st = _rounds(alg, inner, ddt)
    assert st.params.dtype == torch.bfloat16
    if not isinstance(st.delta if alg != "hier_vrl_sgd" else st.delta1,
                      tuple):
        want = torch.float32 if ddt == "float32" else torch.bfloat16
        assert (st.delta if alg != "hier_vrl_sgd" else st.delta1).dtype \
            == want
    _assert_states_bitwise(sj, st, (alg, inner, ddt))


@needs_jax
@pytest.mark.parametrize("alg,ddt", [("vrl_sgd", "float32"),
                                     ("bvr_l_sgd", "bfloat16"),
                                     ("local_sgd", "float32"),
                                     ("hier_vrl_sgd", "bfloat16")])
def test_engine_bf16_overlap_bitwise_reference(alg, ddt):
    sj, st = _rounds(alg, "sgd", ddt, overlap=True, rounds=3)
    _assert_states_bitwise(sj, st, (alg, "overlap"))


@needs_jax
@pytest.mark.parametrize("alg,compress", [("vrl_sgd", "int8"),
                                          ("ssgd", "int8"),
                                          ("easgd", "int8"),
                                          ("vrl_sgd", "topk:8"),
                                          ("hier_vrl_sgd", "int8")])
def test_engine_bf16_compressed_matches_eager_compressors(alg, compress):
    """The compressed syncs at bf16 parameters: the EF payload, residual
    and reference fp32 as in the reference; against its engine op by op,
    where the EF round trip is eager ``repro.comm.compressors``."""
    sj, st = _rounds(alg, "sgd", "float32", compress)
    _assert_states_bitwise(sj, st, (alg, compress))


@needs_jax
@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_engine_bf16_jitted_reference_within_a_bf16_ulp(inner):
    """The JAX engine under ``jit``: XLA's CPU backend contracts a·b + c
    into FMAs (p − γ·v, the Adam EMAs), skipping one fp32 rounding, which
    moves a bf16 rounding of p now and then.  The port (op by op, as the
    CUDA kernels under -fmad=false) parts from it there only: on at most
    1e-3 of the elements, each p within 8 bf16 ulps (one moved rounding,
    carried through the later steps and means), each Δ within what such a
    move gives over k·γ."""
    sj, st = _rounds("vrl_sgd", inner, eager=False)
    x, y = _np(st.params), _np(sj.params)
    ulp = np.spacing(np.abs(y)) * 2.0 ** 16
    assert np.all(np.abs(x - y) <= 8 * ulp)
    assert (x != y).mean() <= 1e-3, (x != y).mean()
    dx, dy = _np(st.delta), _np(sj.delta)
    assert (dx != dy).mean() <= 1e-3
    assert np.abs(dx - dy).max() <= 8 * 2.0 ** -8 * np.abs(y).max() / (
        EK * LR)


# --------------------------------------------- (c) the per-leaf executor
def _tree_fields(state):
    """{field: list of leaves} of a per-leaf state (trees of leaves, host
    ints and empty fields skipped; 0-d step counters too)."""
    from repro_torch import tree as tm
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            for k, leaves in _tree_fields(v).items():
                out[f"{f}/{k}"] = leaves
            continue
        if isinstance(v, dict):
            leaves = (tm.leaves(v) if v and isinstance(
                next(iter(tm.leaves(v)), None), torch.Tensor)
                else jax.tree.leaves(v))
        else:
            leaves = [v] if hasattr(v, "shape") else []
        leaves = [x for x in leaves if getattr(x, "ndim", 0) > 0]
        if leaves:
            out[f] = leaves
    return out


LEAF_SHAPES = {"w": (64, 48), "b": (40,), "u": (2, 16, 24)}


@needs_jax
@pytest.mark.parametrize("alg", FLAT_ALGS + ("hier_vrl_sgd",))
@pytest.mark.parametrize("inner", ["sgd", "momentum", "adam"])
def test_per_leaf_executor_bf16_bitwise_reference(alg, inner):
    """The per-leaf executors of both packages from the same bf16
    parameters over 2k steps of the same bf16 gradients (the JAX one op by
    op): every state leaf bitwise, bf16 parameters kept bf16."""
    from repro.core import get_algorithm as j_get
    from repro_torch.core import get_algorithm as t_get
    rng = np.random.RandomState(11)
    pj = {k: jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
        jnp.bfloat16) for k, shape in LEAF_SHAPES.items()}
    cj, ct = _cfgs(alg, inner, "float32", backend="reference")
    hier = alg == "hier_vrl_sgd"
    ja, ta = j_get(alg), t_get(alg)
    arg = GRID if hier else EW
    lead = GRID if hier else (EW,)
    with jax.disable_jit():
        sj = ja.init(cj, pj, arg)
        st = ta.init(ct, jax.tree.map(_to_torch, pj), arg)
        for _ in range(2 * EK):
            g = jax.tree.map(lambda x: rng.randn(*lead, *x.shape).astype(
                np.float32), pj)
            sj = ja.train_step(cj, sj, jax.tree.map(
                lambda x: jnp.asarray(x).astype(jnp.bfloat16), g))
            st = ta.train_step(ct, st, jax.tree.map(
                lambda x: torch.from_numpy(x).to(torch.bfloat16), g))
    fj, ft = _tree_fields(sj), _tree_fields(st)
    assert set(fj) == set(ft), set(fj) ^ set(ft)
    for f in fj:
        assert len(fj[f]) == len(ft[f]), f
        for a, b in zip(ft[f], fj[f]):
            _bitwise(a, b, (alg, inner, f))
    from repro_torch import tree as tm
    assert all(x.dtype == torch.bfloat16 for x in tm.leaves(st.params))


# ------------------------------------------------------------ checkpoints
@needs_jax
@pytest.mark.parametrize("alg,inner,ddt", [("vrl_sgd", "adam", "float32"),
                                           ("bvr_l_sgd", "momentum",
                                            "bfloat16"),
                                           ("hier_vrl_sgd", "sgd",
                                            "bfloat16")])
def test_checkpoint_bf16_state_cross_framework(tmp_path, alg, inner, ddt):
    """A bf16-parameter engine state (after two rounds, bitwise in both
    packages): the JAX package's file restores in the port bitwise, the
    port's file restores in the JAX package bitwise, the two files hold
    the same keys, shapes and dtype strings ("bfloat16" for the params)."""
    from repro import checkpoint as jck
    from repro.comm import compressors as jcc
    from repro.core import engine as jeng
    from repro_torch import checkpoint as tck
    from repro_torch.comm import compressors as tcc
    from repro_torch.core import engine as teng
    from test_torch_checkpoint import _assert_bitwise, _file_index
    sj, st = _rounds(alg, inner, ddt)
    tj, tt, pj = _smoke()
    cj, ct = _cfgs(alg, inner, ddt)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    d_j, d_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_flat_state(d_j, sj, ej.spec, meta={"step": int(sj.step)},
                        grid=ej.grid,
                        compressors=jcc.pair_meta(ej.compressors),
                        moments=jck.moments_meta(cj))
    st0 = et.init(jax.tree.map(_to_torch, pj), EW)
    back_t = tck.restore_flat_state(
        d_j, st0, et.spec, grid=et.grid,
        compressors=tcc.pair_meta(et.compressors),
        moments=tck.moments_meta(ct))
    _assert_bitwise(back_t, sj)
    assert back_t.params.dtype == torch.bfloat16
    tck.save_flat_state(d_t, st, et.spec, meta={"step": st.step},
                        grid=et.grid,
                        compressors=tcc.pair_meta(et.compressors),
                        moments=tck.moments_meta(ct))
    back_j = jck.restore_flat_state(
        d_t, ej.init(pj, EW), ej.spec, grid=ej.grid,
        compressors=jcc.pair_meta(ej.compressors),
        moments=jck.moments_meta(cj))
    _assert_bitwise(st, back_j)
    index = _file_index(d_t)
    assert index == _file_index(d_j)
    assert index["params"][1] == "bfloat16"


# ------------------------------------------------------------- the mesh
def _mesh_mean(p: torch.Tensor, ranks: int) -> torch.Tensor:
    """The reference's on-mesh worker mean of a bf16 (W, R, C) buffer over
    ``ranks`` ranks of W / ranks workers each: each rank's sum rounded to
    bf16, the fp32 all-reduce of those, rounded to bf16, ÷ W rounded."""
    blocks = p.float().reshape(ranks, -1, *p.shape[1:])
    local = blocks.sum(1).to(torch.bfloat16).float()
    return local.sum(0).to(torch.bfloat16).div_(p.shape[0])


def test_mesh_bf16_rounds_match_one_process(tmp_path):
    """gloo world 2 on the CPU at bf16 parameters against one process.
    The worker mean at bf16 follows the reference's on-mesh sequence:
    each rank's local sum rounded to bf16, the all-reduce carrying fp32,
    the sum rounded back to bf16, ÷ W rounded again.  With one worker a
    rank in each mean (W = 2, and the (2, 2) hierarchy) that is the
    one-process mean's value: three rounds bitwise, overlap too.  With two
    a rank (W = 4) a rank's rounded sum can move x̂ off the one-process
    mean (by up to half an ulp of that sum, more than an ulp of x̂ where
    the workers cancel): there the meshed round is bitwise the one-process
    local steps closed by the sync kernel on that sequence's x̂."""
    import torch.multiprocessing as tmp
    import torch_mesh_ranks as MR
    store, out = str(tmp_path / "store"), str(tmp_path / "bf16")
    tmp.start_processes(MR.bf16_mesh, args=(2, store, out), nprocs=2,
                        start_method="spawn")
    ranks = [torch.load(f"{out}.rank{r}", weights_only=False)
             for r in range(2)]
    kg = torch.full((1, 1), float(MR.K), dtype=torch.float32) * MR.LR
    moved = 0
    for name, (fields, w) in MR.BF16_CASES.items():
        hier = "hier" in fields
        if w == 2 or hier:
            one = MR.run_bf16(name)
        else:
            et, st = MR.run_bf16(name, presync=True)
            xhat = _mesh_mean(st.params, 2)
            moved += int((xhat != st.params.float().mean(0).to(
                torch.bfloat16)).sum())
            if "bias" in MR.buffers(st):
                tu_out = tu.fused_sync_bvr(st.params, xhat, st.delta,
                                           st.bias, kg,
                                           beta=fields["bvr_beta"])
                st = st._replace(params=tu_out[0], delta=tu_out[1],
                                 bias=tu_out[2])
            else:
                p, d = tu.fused_sync_vrl(st.params, xhat, st.delta, kg)
                st = st._replace(params=p, delta=d)
            one = MR.buffers(st)
        for res in ranks:
            mine = res[name]
            idx = mine["idx"]
            for key, got in mine["state"].items():
                want = one[key]
                if got.shape != want.shape:
                    want = (want.reshape(-1, *want.shape[2:])[idx].reshape(
                        got.shape) if hier else want[idx])
                np.testing.assert_array_equal(got, want, err_msg=(name, key))
    assert moved > 0      # the W = 4 means did part from one process's


# ----------------------------------------------------- (d) the train step
@needs_jax
@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_train_step_bf16_matches_reference(inner):
    """``make_train_step(param_dtype=torch.bfloat16)`` beside the JAX
    package's ``make_train_step(param_dtype=jnp.bfloat16)``, from the same
    bf16 parameters (wq, wk × 0.1: the smoke model's attention is near
    one-hot otherwise): one step's mean loss within 1e-2 relative, each
    worker's gradient leaf within 2^-5 · its max|g| (the repo's bf16
    standard), bf16 gradients, a bf16 state with fp32 Δ; then a round
    takes them, its losses finite."""
    from repro.configs import registry as jreg
    from repro.core import flat as jflat
    from repro.models import transformer as JT
    from repro.train.train_loop import make_train_step as j_make
    from repro_torch.configs import registry as treg
    from repro_torch.train.train_loop import make_train_step as t_make
    w, b, seq = 2, 2, 16
    cj, ct = _cfgs("vrl_sgd", inner, "float32", comm_period=2)
    jb = j_make(jreg.smoke_arch("qwen2-0.5b"), cj, remat=False,
                param_dtype=jnp.bfloat16)
    tb = t_make(treg.smoke_arch("qwen2-0.5b"), ct, device="cpu",
                remat=False, param_dtype=torch.bfloat16)
    params = JT.init_params(jreg.smoke_arch("qwen2-0.5b"),
                            jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    js = jb.engine.init(params, w)
    ts = tb.engine.init(jax.tree.map(_to_torch, params), w)
    assert ts.params.dtype == torch.bfloat16
    assert ts.delta.dtype == torch.float32
    rng = np.random.RandomState(2)
    vocab = jreg.smoke_arch("qwen2-0.5b").vocab_size
    toks = rng.randint(0, vocab, (w, b, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    gj, lj = jax.jit(jb.grads_fn)(js, jnp.asarray(toks), jnp.asarray(labels))
    gj = _np(jflat.flatten_stacked(jb.engine.spec, gj))
    gt, lt = tb.grads_fn(ts, torch.from_numpy(toks).long(),
                         torch.from_numpy(labels).long())
    assert gt.dtype == torch.bfloat16
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-2)
    g_t = _np(gt)
    for leaf in tb.engine.spec.leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        for i in range(w):
            a, x = gj.reshape(w, -1)[i, sl], g_t.reshape(w, -1)[i, sl]
            assert np.abs(x - a).max() <= 2.0 ** -5 * np.abs(a).max() + \
                1e-30, (leaf.path, i)
    k = 2
    tk = rng.randint(0, vocab, (k, w, b, seq))
    ts, losses = tb.round_step(ts, torch.from_numpy(tk).long(),
                               torch.from_numpy(np.roll(tk, -1, -1)).long())
    assert torch.isfinite(losses).all() and ts.params.dtype == torch.bfloat16
    state = tb.init_state(0, w)
    assert state.params.dtype == torch.bfloat16


def test_train_round_bf16_compressed_sync_gets_an_fp32_payload():
    """A compressed round of ``make_train_step`` at bf16 parameters: the
    sync's decompressed payload is fp32, so it does not go over the last
    step's (bf16) gradient buffer; the round equals the engine's own steps
    on the same gradients with a fresh fp32 payload, bitwise."""
    from repro_torch.comm import compressors as tcc
    from repro_torch.configs import registry as treg
    from repro_torch.configs.base import VRLConfig as TVRL
    from repro_torch.train.train_loop import make_train_step as t_make
    cfg = treg.smoke_arch("qwen2-0.5b")
    vrl = TVRL(comm_period=2, learning_rate=LR, warmup=False,
               compress=tcc.parse_compressor("int8"))
    tb = t_make(cfg, vrl, device="cpu", remat=False,
                param_dtype=torch.bfloat16)
    st = tb.init_state(0, 2)
    twin = st._replace(**{f: getattr(st, f).clone() for f in
                          ("params", "delta")},
                       comm=st.comm._replace(resid=st.comm.resid.clone(),
                                             ref=st.comm.ref.clone()))
    rng = np.random.RandomState(4)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2, 2, 16)))
    lab = torch.roll(tok, -1, dims=-1)
    st, _ = tb.round_step(st, tok, lab)
    for i in range(2):
        g, _ = tb.grads_fn(twin, tok[i], lab[i])
        twin = tb.engine.local_step(twin, g.clone())
    twin = tb.engine.sync(twin)
    for key in ("params", "delta"):
        _bitwise(getattr(st, key), getattr(twin, key), key)
    _bitwise(st.comm.resid, twin.comm.resid, "resid")


# ------------------------------------------- (e) the kernels on the card
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [R, 1237])
@pytest.mark.parametrize("name,ddt", CASES)
def test_cuda_bf16_kernels_bitwise_plain(name, ddt, r):
    """Each kernel at bf16 p and g with an fp32 and a bf16 Δ, on a
    tile-aligned and a ragged row count, bitwise its plain version on the
    same card tensors (NaN for NaN), in place where the wrapper writes in
    place, one launch a call."""
    dev = _cuda_or_skip()
    args, kw, opts = _torch_args(name, "bf16", ddt, seed=3, device=dev,
                                 r=r - r % 2)
    want = getattr(tu, name)(*args, **kw, **opts)
    inplace = KERNELS[name][3]
    mine = [a.clone() if i in inplace else a for i, a in enumerate(args)]
    n0 = tvu.LAUNCHES[name]
    got = getattr(tvu, name)(*mine, **kw, **opts)
    torch.cuda.synchronize()
    assert tvu.LAUNCHES[name] == n0 + 1
    _bitwise(got, want, name)
    for i in inplace:
        assert any(g is mine[i] for g in _outs(got)), (name, i)


@pytest.mark.cuda
def test_cuda_bf16_nan_rows_and_mixed_gradients():
    """A NaN planted in p and in g propagates as in the plain version (the
    guard's and the chaos check's poison), compared NaN for NaN; an fp32
    gradient beside bf16 parameters (the compressed S-SGD mean) and a bf16
    one beside fp32 parameters take the kernel too."""
    dev = _cuda_or_skip()
    for pdt, gdt in (("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16")):
        args, kw, opts = _torch_args("fused_local_adam", pdt, "f32", seed=5,
                                     device=dev)
        args[1] = args[1].to(TDT[gdt])
        args[0][0, 3, :7] = float("nan")
        args[1][1, 5, 9:20] = float("nan")
        want = tu.fused_local_adam(*args, **kw, **opts)
        mine = [a.clone() if i in (0, 3, 4) else a for i, a in
                enumerate(args)]
        _bitwise(tvu.fused_local_adam(*mine, **kw, **opts), want,
                 (pdt, gdt))


def test_wrappers_take_the_reference_dtypes_and_refuse_the_rest():
    """On the CPU (the plain versions), the roles' dtypes: bf16 p with an
    fp32 or bf16 Δ runs in place; x̂ off p's dtype, Δ and B of two dtypes,
    fp16 anywhere, a bf16 pend or EF residual are refused with the role."""
    args, kw, opts = _torch_args("fused_sync_vrl", "bf16", "f32")
    p0 = args[0].clone()
    p, d = tvu.fused_sync_vrl(*args, **opts)
    assert p is args[0] and p.dtype == torch.bfloat16 and \
        d.dtype == torch.float32 and not torch.equal(p, p0)
    args, kw, opts = _torch_args("fused_sync_vrl", "bf16", "f32")
    with pytest.raises(TypeError, match="parameters"):
        tvu.fused_sync_vrl(args[0], args[1].float(), *args[2:], **opts)
    args, kw, opts = _torch_args("fused_local_sgd", "bf16", "f32")
    with pytest.raises(TypeError, match="drift"):
        tvu.fused_local_sgd(*args, b=kw["b"].bfloat16(), **opts)
    with pytest.raises(TypeError, match="float16"):
        tvu.fused_local_sgd(args[0].half(), *args[1:], **opts)
    args, kw, opts = _torch_args("fused_fold_overlap", "bf16", "bf16")
    args[2] = args[2].bfloat16()
    with pytest.raises(TypeError, match="pend"):
        tvu.fused_fold_overlap(*args, **opts)
    args, kw, opts = _torch_args("fused_ef_int8", "bf16", "f32")
    with pytest.raises(TypeError, match="e is"):
        tvu.fused_ef_int8(args[0], args[1], args[2].bfloat16())
    with pytest.raises(TypeError, match="out is"):
        tvu.fused_ef_int8(*args, out=args[0])
