"""PyTorch port, compressed sync vs the JAX package.

* ``repro_torch.comm.compressors`` agrees with ``repro.comm.compressors``
  on the compressor strings it accepts and the ones it rejects, on every
  label, resolution and byte count, and on the wire arrays
  (``decompress(compress(x))`` compared as dense arrays on tie-free rows,
  since top-k's index order may differ).
* The EF round trip (``ef_int8``, ``ef_topk``) and the plain kernels
  (``kernels/torch_update.fused_ef_*``) are BITWISE ``xla_update``'s twins
  and eager ``ef_int8``/``ef_topk``, over every variant (ref or none, EF or
  none) and rows with ties, all-zero rows and rows with fewer than k
  non-zeros.  Against interpret-mode Pallas, top-k is bitwise and int8 is
  held to one quantisation step per element: the Pallas kernel runs the
  payload and the round trip as one compiled program, which rounds
  x/safe differently at a few elements (ulps of dec, never a whole step
  more, measured), the split that makes the reference's own
  ``test_compressed_xla_matches_fused_bitwise[int8]`` fail.
* The engine under ``compress`` ∈ {int8, topk:4, int8:noef} for every flat
  algorithm, 13 per-step ``train_step``s at k = 4, W = 4 (the reference's
  ``tests/test_compress_engine.py`` template), against ``make_engine(
  update_backend="xla")`` on the same numpy gradients: params atol 1e-5,
  Δ, B and the residual atol 1e-5/(k·γ) (the reference's engine standard)
  wherever no quantisation level or top-k pick flips between the two
  packages' fp32 roundings.  Top-k is held there everywhere: its round
  trip is bitwise the reference's, and no pick flips (measured).  Under
  int8 at most ``max_flips`` elements of a buffer may flip a level (16
  plus one per 1e3; up to 8 of 7,168 measured): a flip moves one element
  of one worker's decompressed payload by one step of its row,
  max|payload row|/127, so a flipped element is held, row by row, to
  twice the sum of those steps over the run's communications (the flip
  and its error feedback).  Planted faults
  (the residual zeroed after each round trip, a wrong k, a stale ref) fail
  these checks.
* ``none`` and ``topk:1`` are bitwise the uncompressed path and add no
  buffers; ``resid' + dec == payload`` bitwise; a blocking compressed sync
  moves Σ_i Δ_i by exactly Σ_i (e_i − e'_i)/(k_eff·γ), to fp32 rounding.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

# ------------------------------------------------------------- compressors
GOOD = ["none", "int8", "topk", "topk:8", "topk:1", "topk:4:noef",
        "int8:noef", "int8:ef", "none:noef", "topk:noef:16", "topk:256",
        "topk:1000"]
BAD = ["", "foo", "int8:4", "none:3", "topk:x", "topk:-2", "int8:noef:z",
       ":"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text", GOOD)
def test_parse_and_resolve_match_reference(text):
    want, got = jcc.parse_compressor(text), tcc.parse_compressor(text)
    assert tuple(got) == tuple(want)
    assert got.label() == want.label()
    assert tcc.is_identity(got) == jcc.is_identity(want)
    assert (tcc.resolve(got) is None) == (jcc.resolve(want) is None)
    assert tcc.meta(got) == jcc.meta(want)
    for lanes in (128, 256):
        assert tcc.topk_k(got, lanes) == jcc.topk_k(want, lanes)
        for rows, size in ((8, 2000), (16, 16 * lanes), (3, 1)):
            kw = dict(rows=rows, lanes=lanes, size=size)
            assert tcc.wire_bytes(tcc.resolve(got), **kw) == \
                jcc.wire_bytes(jcc.resolve(want), **kw)
            assert tcc.wire_bytes(got, rows=rows, lanes=lanes) == \
                jcc.wire_bytes(want, rows=rows, lanes=lanes)


@pytest.mark.parametrize("text", BAD)
def test_parse_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        jcc.parse_compressor(text)
    with pytest.raises(ValueError):
        tcc.parse_compressor(text)


def test_pairs_rows_and_raw_bytes_match_reference():
    class Cfg:
        def __init__(self, compress, compress2=None):
            self.compress, self.compress2 = compress, compress2
    cases = [(None, None), ("int8", None), ("int8", "topk:16"),
             ("none", "int8"), ("topk:1", None), ("topk", "topk"),
             ("int8:noef", "none")]
    for c1, c2 in cases:
        cj, ct = Cfg(c1, c2), Cfg(c1, c2)
        pj, pt = jcc.resolve_pair(cj), tcc.resolve_pair(ct)
        assert [None if x is None else tuple(x) for x in pt] == \
            [None if x is None else tuple(x) for x in pj]
        assert tcc.pair_meta(ct) == jcc.pair_meta(cj)
        assert tcc.describe_pair(ct) == jcc.describe_pair(cj)
        assert tcc.describe_pair(pt) == jcc.describe_pair(pj)
    with pytest.raises(TypeError):
        tcc.as_spec(3)
    for size, lanes in ((1, 256), (256, 256), (257, 256), (10_000, 128)):
        assert tcc.used_rows(size, lanes) == jcc.used_rows(size, lanes)
    assert tcc.raw_bytes(7, 256) == jcc.raw_bytes(7, 256)
    assert tcc.raw_bytes(7, 256, 2) == jcc.raw_bytes(7, 256, 2)


@pytest.mark.parametrize("text", ["int8", "topk:4", "topk", "none"])
def test_wire_arrays_match_reference(text):
    rng = np.random.RandomState(11)
    x = rng.randn(3, 12, 256).astype(np.float32)     # tie-free rows
    x[:, 9:] = 0.0                                   # tile padding rows
    spec_j, spec_t = jcc.parse_compressor(text), tcc.parse_compressor(text)
    rep_j = jcc.compress(spec_j, jnp.asarray(x), rows_used=9)
    rep_t = tcc.compress(spec_t, torch.from_numpy(x), rows_used=9)
    assert tcc.rep_nbytes(rep_t) == jcc.rep_nbytes(rep_j)
    if not tcc.is_identity(spec_t):
        # wire_bytes counts one worker's (R, C) payload
        assert tcc.rep_nbytes(rep_t) == 3 * tcc.wire_bytes(
            spec_t, rows=12, lanes=256, size=9 * 256)
    dec_j = jcc.decompress(spec_j, rep_j, rows=12, lanes=256)
    dec_t = tcc.decompress(spec_t, rep_t, rows=12, lanes=256)
    assert tuple(dec_t.shape) == (3, 12, 256)
    np.testing.assert_array_equal(dec_t.numpy(), np.asarray(dec_j))
    if text == "int8":
        np.testing.assert_array_equal(rep_t.values.numpy(),
                                      np.asarray(rep_j.values))
        np.testing.assert_array_equal(rep_t.scales.numpy(),
                                      np.asarray(rep_j.scales))


# ---------------------------------------------- EF round trip, plain kernels
W, R, C, BLOCK = 3, 16, 256, 8


def special_rows(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Rows 0-3 of every worker: ± ties at the top magnitudes, all zeros,
    fewer than k non-zeros, and exact ties of one magnitude across all
    lanes (int8: exact .5 levels)."""
    x = x.copy()
    x[:, 0] *= 0.1
    x[:, 0, :6] = [3.0, -3.0, 3.0, -2.5, 2.5, 2.5]
    x[:, 1] = 0.0
    x[:, 2] = 0.0
    x[:, 2, :k // 2] = np.linspace(0.5, 1.0, k // 2)
    x[:, 3] = np.where(np.arange(x.shape[-1]) % 2, 1.0, -1.0)
    x[:, 3, 0] = 127.0 * 2.0           # scale 2: every ±1 is x/safe = .5
    return x


def _ef_inputs(seed, w=W, r=R):
    rng = np.random.RandomState(seed)
    p = special_rows(rng.randn(w, r, C).astype(np.float32))
    ref = rng.randn(r, C).astype(np.float32) * 0.1
    e = rng.randn(w, r, C).astype(np.float32) * 0.01
    return p, ref, e


EF_CASES = [(mode, use_ref, use_e) for mode in ("int8", "topk:8", "topk:64",
                                                "topk:256")
            for use_ref in (False, True) for use_e in (False, True)]


def _plain(mode, p, ref, e):
    if mode == "int8":
        return tu.fused_ef_int8(p, ref, e)
    return tu.fused_ef_topk(p, ref, e, k=int(mode.split(":")[1]))


def _jax(mod, mode, p, ref, e, **kw):
    if mode == "int8":
        return mod.fused_ef_int8(p, ref, e, **kw)
    return mod.fused_ef_topk(p, ref, e, k=int(mode.split(":")[1]), **kw)


def _opt(x, on, conv):
    return conv(x) if on else None


@pytest.mark.parametrize("mode,use_ref,use_e", EF_CASES)
def test_plain_ef_bitwise_xla_and_eager(mode, use_ref, use_e):
    p, ref, e = _ef_inputs(0)
    t = torch.from_numpy
    dec, res = _plain(mode, t(p), _opt(ref, use_ref, t), _opt(e, use_e, t))
    jdec, jres = _jax(jxu, mode, jnp.asarray(p), _opt(ref, use_ref,
                                                      jnp.asarray),
                      _opt(e, use_e, jnp.asarray))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    assert (res is None) == (jres is None) == (not use_e)
    if use_e:
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    # eager reference round trip on the same payload, and the EF invariant
    x = p - ref if use_ref else p.copy()
    if use_e:
        x = x + e
    want = (jcc.ef_int8(jnp.asarray(x)) if mode == "int8" else
            jcc.ef_topk(jnp.asarray(x), int(mode.split(":")[1])))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(want[0]))
    got_x = tu._ef_payload(t(p), _opt(ref, use_ref, t), _opt(e, use_e, t))
    np.testing.assert_array_equal(got_x.numpy(), x)
    if use_e:
        np.testing.assert_array_equal((res + dec).numpy(), x)


@pytest.mark.parametrize("mode,use_ref,use_e", EF_CASES)
def test_plain_ef_vs_pallas_interpret(mode, use_ref, use_e):
    """Top-k bitwise; int8 within one quantisation step per element (see
    the module docstring), with the residual off by the same amount."""
    p, ref, e = _ef_inputs(1)
    t = torch.from_numpy
    dec, res = _plain(mode, t(p), _opt(ref, use_ref, t), _opt(e, use_e, t))
    jdec, jres = _jax(jvu, mode, jnp.asarray(p),
                      _opt(ref, use_ref, jnp.asarray),
                      _opt(e, use_e, jnp.asarray), block=BLOCK,
                      interpret=True)
    if mode != "int8":
        np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
        if use_e:
            np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        return
    x = tu._ef_payload(t(p), _opt(ref, use_ref, t),
                       _opt(e, use_e, t)).numpy()
    step = np.abs(x).max(axis=-1, keepdims=True) / np.float32(127.0)
    tol = step + np.spacing(np.abs(dec.numpy()))
    assert np.all(np.abs(dec.numpy() - np.asarray(jdec)) <= tol)
    if use_e:
        assert np.all(np.abs(res.numpy() - np.asarray(jres)) <= tol)


def test_ef_roundtrip_special_rows():
    """All-zero rows give zeros; ties at the threshold keep every tied
    lane; rows with fewer than k non-zeros keep them all; k ≥ C keeps
    everything with a zero residual; int8 rounds exact halves to even."""
    p, _, _ = _ef_inputs(2)
    x = torch.from_numpy(p)
    dec, res = tcc.ef_topk(x, 2)
    # row 0: |3| tied three times at the top: all three kept
    assert torch.equal(dec[0, 0, :3], x[0, 0, :3])
    assert int((dec[0, 0] != 0).sum()) == 3
    assert not dec[:, 1].any() and not res[:, 1].any()
    d8, _ = tcc.ef_topk(x, 8)
    assert torch.equal(d8[:, 2], x[:, 2])        # 4 non-zeros, k = 8
    dk, rk = tcc.ef_topk(x, C)
    assert torch.equal(dk, x) and not rk.any()
    di, ri = tcc.ef_int8(x)
    assert not di[:, 1].any()
    # ±1 at scale 2: x/safe = ±0.5 rounds to 0 (half to even)
    assert not di[:, 3, 1:].any()
    assert torch.equal(ri + di, x)


def test_ef_wrappers_on_cpu():
    """In place resid, ``out=`` (which may be p itself), no launch counted
    for a CPU tensor, and refusals of what the kernels do not take."""
    p, ref, e = (torch.from_numpy(a) for a in _ef_inputs(3))
    want_dec, want_res = tu.fused_ef_int8(p, ref, e)
    tvu.reset_launches()
    e1 = e.clone()
    dec, res = tvu.fused_ef_int8(p, ref, e1)
    assert res is e1 and torch.equal(res, want_res)
    assert torch.equal(dec, want_dec)
    out = torch.empty_like(p)
    dec2, _ = tvu.fused_ef_topk(p, ref, e.clone(), k=8, out=out)
    assert dec2 is out
    assert torch.equal(out, tu.fused_ef_topk(p, ref, e, k=8)[0])
    g = p.clone()
    dec3, none = tvu.fused_ef_int8(g, None, None, out=g)
    assert dec3 is g and none is None
    assert torch.equal(g, tu.fused_ef_int8(p, None, None)[0])
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="one buffer"):
        tvu.fused_ef_int8(p, ref, e, out=e)
    with pytest.raises(ValueError, match="ref"):
        tvu.fused_ef_int8(p, ref[:-1], e)
    with pytest.raises(ValueError, match="k must be"):
        tvu.fused_ef_topk(p, ref, e, k=0)
    with pytest.raises(TypeError):
        tvu.fused_ef_int8(p.double(), None, None)


# ------------------------------------------------------ engine, compressed
EW, EK, ESTEPS, ELR = 4, 4, 13, 0.05
# the reference template's tree, widened to 1,600 elements (7 rows of 256
# lanes, 6 of them full) so that top-k:4 drops lanes and int8 scales vary
# by row
TEMPLATE = {"w": (40, 30), "b": (70,), "deep": {"u": (2, 5, 33)}}
COMPRESSED_ALGS = ["vrl_sgd", "local_sgd", "bvr_l_sgd", "easgd", "ssgd",
                   "stl_sgd"]


def templates():
    tj = jax.tree.map(lambda s: jnp.zeros(s, jnp.float32), TEMPLATE,
                      is_leaf=lambda x: isinstance(x, tuple))
    tt = jax.tree.map(lambda s: torch.empty(s, device="meta"), TEMPLATE,
                      is_leaf=lambda x: isinstance(x, tuple))
    return tj, tt


def params0():
    ks = iter(jax.random.split(jax.random.PRNGKey(7), 3))
    return jax.tree.map(lambda s: jax.random.normal(next(ks), s), TEMPLATE,
                        is_leaf=lambda x: isinstance(x, tuple))


def grad_buf(spec_j, seed, w=EW):
    """(W, R, C) fp32 gradients with zero pad lanes, from numpy."""
    rng = np.random.RandomState(seed)
    out = np.zeros((w, spec_j.rows, spec_j.lanes), np.float32)
    out.reshape(w, -1)[:, :spec_j.size] = rng.randn(w, spec_j.size)
    return out


def engine_cfgs(alg, compress, k=EK, **over):
    kw = dict(algorithm=alg, comm_period=k, learning_rate=ELR,
              weight_decay=1e-3, warmup=False, **over)
    cj = JVRL(update_backend="xla",
              compress=None if compress is None else
              jcc.parse_compressor(compress), **kw)
    ct = TVRL(compress=None if compress is None else
              tcc.parse_compressor(compress), **kw)
    return cj, ct


def step_bound(mode, payload):
    """Per row, the most one flipped decision moves an element of the
    decompressed payload, the largest over workers, as an (R, 1) array: one
    int8 level, max|row|/127; one top-k pick, the row's kth-largest |x|
    (what one package keeps and the other drops lies at the threshold)."""
    a = np.abs(np.asarray(payload, np.float64))
    a = a.reshape(-1, *a.shape[-2:])
    spec = tcc.parse_compressor(mode)
    if spec.name == "int8":
        step = a.max(axis=-1) / 127.0
    else:
        k = min(tcc.topk_k(spec, a.shape[-1]), a.shape[-1])
        step = -np.partition(-a, k - 1, axis=-1)[..., k - 1]
    return step.max(axis=0)[:, None]


def max_flips(mode, size, picks=False):
    """Flipped elements a buffer of ``size`` elements may hold: none
    uncompressed, nor under top-k unless ``picks`` (a free-running model,
    whose two packages' matmuls round apart); else 16 plus one per 1e3
    elements.  Measured: up to 8 of 7,168 (one flip in one worker's row
    moves the worker mean, so W parameter elements) and 234 of 655,360
    (easgd + int8:noef's ref, where no error feedback takes a flip back);
    a fault moves nearly every element."""
    if mode is None or not (picks or mode.startswith("int8")):
        return 0
    return 16 + size // 1000


def run_pair(alg, compress, steps=ESTEPS, k=EK, **over):
    """Both engines, per step, on the same numpy gradients: the JAX one by
    its own local_step and sync (the host decides the cadence, as
    train_step's cond does), the port by ``train_step``.  Returns the
    engines, final states and the summed step bound of the run's
    communications, taken from the JAX payloads."""
    tj, tt = templates()
    cj, ct = engine_cfgs(alg, compress, k, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    assert et.spec.meta() == ej.spec.meta()
    p0 = params0()
    sj = ej.init(p0, EW)
    st = et.init(from_numpy(jax.tree.map(np.asarray, p0)), EW)
    local_j, sync_j = jax.jit(ej.local_step), jax.jit(ej.sync)
    algo = teng.get_spec(alg)
    active = et.compressors[0] is not None
    bound = 0.0
    for t in range(steps):
        g = grad_buf(ej.spec, 300 + t)
        if active and algo.grad_all_reduce:
            e = (0.0 if isinstance(sj.comm.resid, tuple)
                 else np.asarray(sj.comm.resid))
            bound += step_bound(compress, g + e)
        sj = local_j(sj, jflat.unflatten_stacked(ej.spec, jnp.asarray(g)))
        st = et.train_step(st, torch.from_numpy(g.copy()))
        if algo.sync != "none" and teng.should_sync(algo, ct, int(sj.step),
                                                    int(sj.last_sync)):
            if active:
                cm = sj.comm
                x = np.asarray(sj.params) - np.asarray(cm.ref)[None]
                if not isinstance(cm.resid, tuple):
                    x = x + np.asarray(cm.resid)
                bound += step_bound(compress, x)
            sj = sync_j(sj)
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    return ej, et, sj, st, bound


def close_or_flipped(got, want, atol, flip, name, mode, picks=False):
    """Every element within atol but at most ``max_flips`` — where a
    quantisation level (or, with ``picks``, a top-k pick) flipped between
    the packages — and each of those within ``flip`` (a scalar, or per row:
    an (R, 1) array).  Returns the count of flipped elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    flipped = diff > atol
    n, limit = int(flipped.sum()), max_flips(mode, diff.size, picks)
    assert n <= limit, (name, f"{n} elements beyond atol {atol}, at most "
                        f"{limit} may flip", diff.max())
    allowed = np.broadcast_to(flip, diff.shape)[flipped]
    assert np.all(diff[flipped] <= allowed), (name, diff.max(), flip)
    return n


def compare_states(sj, st, bound, k, compress, lr=ELR):
    flips, kg = {}, k * lr
    flips["params"] = close_or_flipped(st.params.numpy(), sj.params, 1e-5,
                                       2 * bound, "params", compress)
    for name in ("delta", "bias"):
        a, b = getattr(st, name), getattr(sj, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape"), name
        if isinstance(a, torch.Tensor):
            flips[name] = close_or_flipped(a.numpy(), b, 1e-5 / kg,
                                           2 * bound / kg, name, compress)
    if isinstance(st.center, torch.Tensor):
        flips["center"] = close_or_flipped(st.center.numpy(), sj.center,
                                           1e-5, 2 * bound, "center",
                                           compress)
    cm_t, cm_j = st.comm, sj.comm
    assert isinstance(cm_t, tuple) and isinstance(cm_j, tuple)
    if cm_t == () or cm_j == ():
        assert cm_t == () and cm_j == ()
        return flips
    assert isinstance(cm_t.resid, torch.Tensor) == hasattr(cm_j.resid,
                                                           "shape")
    assert isinstance(cm_t.ref, torch.Tensor) == hasattr(cm_j.ref, "shape")
    if isinstance(cm_t.resid, torch.Tensor):
        flips["resid"] = close_or_flipped(cm_t.resid.numpy(), cm_j.resid,
                                          1e-5, 2 * bound, "resid", compress)
    if isinstance(cm_t.ref, torch.Tensor):
        flips["ref"] = close_or_flipped(cm_t.ref.numpy(), cm_j.ref, 1e-5,
                                        2 * bound, "ref", compress)
    return flips


@pytest.mark.parametrize("compress", ["int8", "topk:4", "int8:noef"])
@pytest.mark.parametrize("alg", COMPRESSED_ALGS)
def test_compressed_engine_matches_reference(alg, compress):
    ej, et, sj, st, bound = run_pair(alg, compress)
    assert bound.max() > 0
    flips = compare_states(sj, st, bound, EK, compress)
    print(f"{alg}+{compress}: flipped elements {flips} (largest row step "
          f"bound {bound.max():.3e})")
    assert et.compressors[0] == tcc.parse_compressor(compress)
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: x.numpy(), et.average_model(st)))):
        close_or_flipped(b, a, 1e-5, 2 * bound.max(), "average_model",
                         compress)


def _resid_zeroed(ef):
    def op(p, ref, e, **kw):
        dec, e = ef(p, ref, e, **kw)
        if e is not None:
            e.zero_()
        return dec, e
    return op


def _stale_ref(ef):
    first = {}

    def op(p, ref, e, **kw):
        if ref is not None:
            ref = first.setdefault("ref", ref.clone())
        return ef(p, ref, e, **kw)
    return op


def _plant(monkeypatch, fault):
    if fault == "wrong k":
        topk_k = tcc.topk_k
        monkeypatch.setattr(tcc, "topk_k", lambda c, n: topk_k(c, n) + 1)
        return
    wrap = {"resid zeroed": _resid_zeroed, "stale ref": _stale_ref}[fault]
    ef_op = teng._ef_op
    monkeypatch.setattr(teng, "_ef_op", lambda c, n: wrap(ef_op(c, n)))


@pytest.mark.parametrize("alg,compress,fault", [
    ("vrl_sgd", "int8", "resid zeroed"), ("vrl_sgd", "topk:4", "resid zeroed"),
    ("ssgd", "topk:4", "resid zeroed"), ("vrl_sgd", "int8", "stale ref"),
    ("local_sgd", "topk:4", "stale ref"), ("vrl_sgd", "topk:4", "wrong k")])
def test_parity_check_catches_planted_faults(monkeypatch, alg, compress,
                                             fault):
    """The port with a planted EF fault — the residual zeroed after every
    round trip, the payload taken against the first ref, or one more lane
    kept per row — fails the comparison the port passes."""
    _plant(monkeypatch, fault)
    _, _, sj, st, bound = run_pair(alg, compress)
    with pytest.raises(AssertionError):
        compare_states(sj, st, bound, EK, compress)


@pytest.mark.parametrize("compress", ["none", "topk:1"])
@pytest.mark.parametrize("alg", COMPRESSED_ALGS)
def test_identity_compressors_are_the_uncompressed_path(alg, compress):
    _, et0, _, s0, _ = run_pair(alg, None, steps=9)
    _, et1, _, s1, _ = run_pair(alg, compress, steps=9)
    assert s1.comm == () and et1.compressors == (None, None)
    assert torch.equal(s0.params, s1.params)
    for name in ("delta", "bias", "center"):
        a, b = getattr(s0, name), getattr(s1, name)
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("compress", ["int8", "topk:4"])
@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd"])
def test_blocking_sync_moves_delta_sum_by_ef_term(alg, compress):
    """x̂ − mean_i p_i = mean_i(e_i − e'_i), so each compressed sync moves
    Σ_i Δ_i by Σ_i (e_i − e'_i)/(k_eff γ) — to the fp32 rounding of x̂
    (2 W ulp(max|p|)/(k_eff γ)) and of Δ + u and the sums (1e-4 · the
    larger max|Δ| before or after the sync) — and Σ_i Δ_i itself is no
    longer ~0 (Σ_i B_i moves by β times the same)."""
    tj, tt = templates()
    _, ct = engine_cfgs(alg, compress)
    et = teng.make_engine(ct, tt)
    st = et.init(from_numpy(jax.tree.map(np.asarray, params0())), EW)
    moved_any = 0.0
    for r in range(3):
        gk = np.stack([grad_buf(et.spec, 500 + 10 * r + i)
                       for i in range(EK)])
        for g in gk:
            st = et.local_step(st, torch.from_numpy(g))
        sum_d0 = st.delta.sum(dim=0)
        sum_b0 = st.bias.sum(dim=0) if isinstance(st.bias,
                                                  torch.Tensor) else None
        sum_e0 = st.comm.resid.sum(dim=0)
        max_p = st.params.abs().max().item()
        max_d = st.delta.abs().max().item()
        st = et.sync(st)
        term = (sum_e0 - st.comm.resid.sum(dim=0)) / (EK * ELR)
        moved = st.delta.sum(dim=0) - sum_d0
        rounding = (2 * EW * float(np.spacing(np.float32(max_p)))
                    / (EK * ELR))
        limit = 1e-4 * max(max_d, st.delta.abs().max().item()) + rounding
        assert (moved - term).abs().max().item() <= limit
        if sum_b0 is not None:
            moved_b = st.bias.sum(dim=0) - 0.5 * sum_b0
            assert (moved_b - 0.5 * term).abs().max().item() <= limit
        moved_any = max(moved_any, term.abs().max().item())
    assert moved_any > 10 * limit        # the EF term is not rounding


def test_ef_invariant_through_the_engine():
    """resid' + dec == payload, bitwise, for the sync's own round trip."""
    tj, tt = templates()
    for compress in ("int8", "topk:4"):
        _, ct = engine_cfgs("vrl_sgd", compress)
        et = teng.make_engine(ct, tt)
        st = et.init(from_numpy(jax.tree.map(np.asarray, params0())), EW)
        for i in range(EK):
            st = et.local_step(st, torch.from_numpy(grad_buf(et.spec, i)))
        e0 = st.comm.resid.clone()
        payload = (st.params - st.comm.ref[None]) + e0
        ef = teng._ef_op(tcc.parse_compressor(compress), et.spec.lanes)
        dec, res = ef(st.params, st.comm.ref, e0)
        assert torch.equal(res + dec, payload)


@pytest.mark.parametrize("alg,compress", [("vrl_sgd", "int8"),
                                          ("easgd", "topk:4")])
def test_sync_writes_dec_over_a_dead_buffer(alg, compress):
    """``sync(state, out=g)`` is bitwise ``sync(state)``, writes the
    decompressed payload over ``g`` (the train loop's dead gradients), and
    leaves g's pad lanes zero, as the next step's gradients need them."""
    tj, tt = templates()
    _, ct = engine_cfgs(alg, compress)
    et = teng.make_engine(ct, tt)
    s1 = et.init(from_numpy(jax.tree.map(np.asarray, params0())), EW)
    s2 = et.init(from_numpy(jax.tree.map(np.asarray, params0())), EW)
    for r in range(3):
        for i in range(EK):
            g = torch.from_numpy(grad_buf(et.spec, 900 + 10 * r + i))
            s1 = et.local_step(s1, g.clone())
            s2 = et.local_step(s2, g)
        s1 = et.sync(s1)
        s2 = et.sync(s2, out=g)
        assert not torch.equal(g, torch.from_numpy(grad_buf(et.spec, 903
                                                            + 10 * r)))
        assert not g.reshape(EW, -1)[:, et.spec.size:].any()
    for a, b in ((s1.params, s2.params), (s1.comm.resid, s2.comm.resid),
                 (s1.comm.ref, s2.comm.ref)):
        assert torch.equal(a, b)
    for name in ("delta", "center"):
        if isinstance(getattr(s1, name), torch.Tensor):
            assert torch.equal(getattr(s1, name), getattr(s2, name))


def test_compress2_is_refused():
    """A flat algorithm accepts the hierarchy's level-2 compressor and
    ignores it, as the reference's do: the engine keeps the resolved pair
    (so ``pair_meta`` of the engine and of the config agree with the
    reference's) and runs bitwise the run without it."""
    import dataclasses
    tj, tt = templates()
    cj0, ct0 = engine_cfgs("vrl_sgd", "int8")
    p0 = from_numpy(jax.tree.map(np.asarray, params0()))
    runs = []
    for c2 in (None, "int8", "none", "topk:4"):
        cj, ct = cj0, ct0
        if c2 is not None:
            cj = dataclasses.replace(cj0, compress2=jcc.parse_compressor(c2))
            ct = dataclasses.replace(ct0, compress2=tcc.parse_compressor(c2))
        et, ej = teng.make_engine(ct, tt), jeng.make_engine(cj, tj)
        assert et.compressors == tcc.resolve_pair(ct)
        assert tcc.pair_meta(et.compressors) == tcc.pair_meta(ct) \
            == jcc.pair_meta(ej.compressors)
        st = et.init(p0, EW)
        for t in range(9):
            st = et.train_step(st, torch.from_numpy(grad_buf(et.spec, t)))
        runs.append(st)
    for st in runs[1:]:
        for a, b in ((runs[0].params, st.params), (runs[0].delta, st.delta),
                     (runs[0].comm.resid, st.comm.resid)):
            assert torch.equal(a, b)
