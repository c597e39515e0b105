"""PyTorch port, checkpoints vs the JAX package (``repro_torch.checkpoint``).

* Cross-framework, both directions, for vrl_sgd + sgd, bvr_l_sgd + adam,
  easgd + momentum, vrl_sgd + int8, bvr_l_sgd + topk + overlap,
  hier_vrl_sgd (2, 2) + int8 + overlap, adam + SM3 with bf16 moments over
  two layout shards, and the per-leaf executor's ``WorkerState``: the JAX
  engine runs two rounds from numpy parameters and saves
  (``repro.checkpoint``); the port restores the file, every leaf BITWISE
  (bf16 by its bits); both continue two rounds on the same gradients and
  agree to atol 1e-5 (Δ-like fields 1e-5/(kγ), bf16 moments one bf16 ulp
  beyond; int8 cases with the flip allowance of ROADMAP Queue 3,
  ``test_torch_compress.close_or_flipped``); the port saves, the JAX
  package restores that file bitwise; the two files hold the same keys,
  shapes and dtype strings (``treedef`` aside).
* ``restore_resharded`` for W 4 → 3, 2 → 5, 4 → 2, with and without
  int8 + overlap (and a bf16 Δ): bitwise the JAX function on the same
  file; Σ_i Δ_i and Σ_i B_i zero to fp32 rounding.
* The reference's own cases (``tests/test_checkpoint.py``) on the port.
* The CLI: a resumed run is bitwise the uninterrupted one (losses and the
  final checkpoint); ``--resume auto`` with nothing saved starts fresh; a
  resume past ``--steps`` evaluates the restored model; gloo meshes of 2
  ranks save for one process and resume what one process saved, bitwise,
  with one model-state all-reduce a round; the end-to-end example.
"""
import dataclasses
import glob
import json
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import EngineConfig as JEC  # noqa: E402
from repro.configs.base import HierConfig as JHC  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import get_algorithm as j_alg  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import EngineConfig as TEC  # noqa: E402
from repro_torch.configs.base import HierConfig as THC  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import get_algorithm as t_alg  # noqa: E402
from repro_torch.data.partition import (class_shard_partition,  # noqa: E402
                                        repartition)
from repro_torch.kernels import vrl_update as vu  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402

from test_torch_compress import close_or_flipped, step_bound  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEMPLATE = {"w": (40, 24), "b": (17,)}
W, K, LR = 4, 2, 0.05
HIER = dict(k1=2, k2=4, grid=(2, 2))
# name -> the VRLConfig fields of both packages (compressor as text,
# hierarchy and engine as dicts)
CASES = {
    "vrl_sgd+sgd": dict(algorithm="vrl_sgd"),
    "bvr_l_sgd+adam": dict(algorithm="bvr_l_sgd", inner_optimizer="adam"),
    "easgd+momentum": dict(algorithm="easgd", inner_optimizer="momentum",
                           momentum=0.9),
    "vrl_sgd+int8": dict(algorithm="vrl_sgd", compress="int8"),
    "bvr_l_sgd+topk+overlap": dict(algorithm="bvr_l_sgd", compress="topk",
                                   overlap=True),
    "hier+int8+overlap": dict(algorithm="hier_vrl_sgd", compress="int8",
                              overlap=True, hier=HIER),
    "adam+sm3+bf16, 2 shards": dict(algorithm="vrl_sgd",
                                    inner_optimizer="adam", sm3=True,
                                    moment_dtype="bfloat16",
                                    engine=dict(block=8, shards=2)),
}
DELTA_LIKE = ("delta", "bias", "delta1", "delta2")


def _cfgs(**kw):
    kw = dict(comm_period=K, learning_rate=LR, warmup=False, **kw)
    comp, hier, eng = (kw.pop("compress", None), kw.pop("hier", None),
                       kw.pop("engine", None))
    cj = JVRL(update_backend="xla", **kw,
              compress=jcc.parse_compressor(comp) if comp else None,
              hier=JHC(**hier) if hier else None,
              **({"engine": JEC(**eng)} if eng else {}))
    ct = TVRL(update_backend="xla", **kw,
              compress=tcc.parse_compressor(comp) if comp else None,
              hier=THC(**hier) if hier else None,
              **({"engine": TEC(**eng)} if eng else {}))
    return cj, ct


def _params0():
    rng = np.random.RandomState(3)
    return {k: rng.randn(*s).astype(np.float32) for k, s in TEMPLATE.items()}


def _engines(cj, ct):
    ej = jeng.make_engine(cj, {k: jnp.zeros(s) for k, s in
                               TEMPLATE.items()})
    et = teng.make_engine(ct, {k: torch.empty(s, device="meta")
                               for k, s in TEMPLATE.items()})
    assert et.spec.meta() == ej.spec.meta()
    return ej, et


def _grads(spec, lead, k, seed):
    """(k, *lead, R, C) fp32 gradients, zero pad lanes, from numpy."""
    out = np.zeros((k, int(np.prod(lead)), spec.rows, spec.lanes),
                   np.float32)
    rng = np.random.RandomState(seed)
    out.reshape(k, out.shape[1], -1)[..., :spec.size] = rng.randn(
        k, out.shape[1], spec.size)
    return out.reshape(k, *lead, spec.rows, spec.lanes)


def _jax_leaves(state) -> dict:
    """{checkpoint key: numpy} of a JAX state (the reference's keys)."""
    return {k: np.asarray(v) for k, v in jck.checkpoint._flatten(
        state).items()}


def _port_leaves(state) -> dict:
    return dict(tm.state_leaves(state))


def _bits(x):
    """A leaf as comparable numpy: bf16 by its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def _assert_bitwise(port_state, jax_state):
    pl, jl = _port_leaves(port_state), _jax_leaves(jax_state)
    assert sorted(pl) == sorted(jl)
    for key in jl:
        a, b = _bits(pl[key]), _bits(jl[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _file_index(path):
    info = jck.load_meta(path)
    return {k: (info["shapes"][k], info["dtypes"][k]) for k in info["keys"]}


def _save_jax(path, ej, cj, sj, step):
    jck.save_flat_state(path, sj, ej.spec, meta={"step": step},
                        grid=ej.grid,
                        compressors=jcc.pair_meta(ej.compressors),
                        moments=jck.moments_meta(cj))


def _restore_port(path, et, ct, st0):
    return tck.restore_flat_state(
        path, st0, et.spec, grid=et.grid,
        compressors=tcc.pair_meta(et.compressors),
        moments=tck.moments_meta(ct))


class _Payloads:
    """Records, around the port's int8 EF kernels, the largest int8 step
    (max|row|/127 of the payload) of every round trip: what one flipped
    level can move an element by."""

    def __init__(self, monkeypatch):
        self.bound = 0.0
        for name in ("fused_ef_int8", "fused_ef_int8_grid"):
            monkeypatch.setattr(vu, name, self._wrap(getattr(vu, name)))

    def _wrap(self, fn):
        def op(p, ref, e, **kw):
            x = p.to(torch.float32)
            if ref is not None:
                x = x - ref
            if e is not None:
                x = x + e
            self.bound += float(step_bound("int8", x.numpy()).max())
            return fn(p, ref, e, **kw)
        return op


def _close(name, got, want, atol, compress, flip):
    """Within ``atol`` (bf16: and one bf16 ulp); int8: all but the flip
    allowance, each flipped element within ``flip``."""
    if got.dtype == torch.bfloat16:
        g = got.to(torch.float32).numpy()
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=atol,
                                   err_msg=name)
        return
    got, want = got.numpy(), np.asarray(want)
    if compress and compress.startswith("int8"):
        close_or_flipped(got, want, atol, flip, name, compress)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_flat_checkpoints_cross_framework(tmp_path, monkeypatch, case):
    kw = dict(CASES[case])
    cj, ct = _cfgs(**kw)
    payloads = _Payloads(monkeypatch)
    ej, et = _engines(cj, ct)
    hier = et.grid is not None
    lead = tuple(et.grid) if hier else (W,)
    p0 = _params0()
    sj = ej.init({k: jnp.asarray(v) for k, v in p0.items()}, W)
    rnd = jax.jit(ej.round_step_flat)
    for r in range(2):
        sj = rnd(sj, jnp.asarray(_grads(ej.spec, lead, K, 10 + r)))
    d = str(tmp_path / "jax")
    _save_jax(d, ej, cj, sj, int(sj.step))
    # 1. the port restores the JAX file, every leaf bitwise
    st0 = et.init({k: torch.from_numpy(v) for k, v in p0.items()}, W)
    st = _restore_port(d, et, ct, st0)
    _assert_bitwise(st, sj)
    assert isinstance(st.step, int) and st.step == 2 * K
    # 2. both continue two rounds on the same gradients
    for r in range(2, 4):
        g = _grads(ej.spec, lead, K, 10 + r)
        sj = rnd(sj, jnp.asarray(g))
        st = et.round_step_flat(st, torch.from_numpy(g))
    pl, jl = _port_leaves(st), _jax_leaves(sj)
    assert sorted(pl) == sorted(jl)
    comp = kw.get("compress")
    for key, want in jl.items():
        got = pl[key]
        if not isinstance(got, torch.Tensor):
            assert got == int(want), key
            continue
        # Δ-like fields over k γ; the moments relative to their scale
        scale = 1.0 / (K * LR) if key in DELTA_LIKE else 1.0
        if key.startswith("inner/"):
            scale = max(1.0, float(np.abs(np.asarray(
                want, np.float32)).max()))
        _close(key, got, want, 1e-5 * scale, comp,
               2 * payloads.bound * scale)
    # 3. the port saves; the JAX package restores that file bitwise
    d2 = str(tmp_path / "port")
    tck.save_flat_state(d2, st, et.spec, meta={"step": st.step},
                        grid=et.grid,
                        compressors=tcc.pair_meta(et.compressors),
                        moments=tck.moments_meta(ct))
    back = jck.restore_flat_state(d2, sj, ej.spec, grid=ej.grid,
                                  compressors=jcc.pair_meta(ej.compressors),
                                  moments=jck.moments_meta(cj))
    _assert_bitwise(st, back)
    # 4. the same keys, shapes and dtype strings in both files
    _save_jax(str(tmp_path / "jax2"), ej, cj, sj, int(sj.step))
    assert _file_index(d2) == _file_index(str(tmp_path / "jax2"))
    assert jck.load_meta(d2)["treedef"].startswith("repro_torch ")


def test_per_leaf_worker_state_cross_framework(tmp_path):
    """The per-leaf executor's ``WorkerState`` (vrl_sgd + adam: trees of
    params, Δ, mu, nu and the host-integer count)."""
    cj, ct = _cfgs(inner_optimizer="adam")
    aj, at = j_alg("vrl_sgd"), t_alg("vrl_sgd")
    p0 = _params0()
    sj = aj.init(cj, {k: jnp.asarray(v) for k, v in p0.items()}, W)
    step = jax.jit(lambda s, g: aj.train_step(cj, s, g))
    rng = np.random.RandomState(5)
    grads = [{k: rng.randn(W, *s).astype(np.float32)
              for k, s in TEMPLATE.items()} for _ in range(4 * K)]
    for g in grads[:2 * K]:
        sj = step(sj, {k: jnp.asarray(v) for k, v in g.items()})
    d = str(tmp_path / "jax")
    jck.save(d, sj, meta={"step": int(sj.step)})
    st0 = at.init(ct, {k: torch.from_numpy(v) for k, v in p0.items()}, W)
    st = tck.restore(d, st0)
    _assert_bitwise(st, sj)
    assert isinstance(st.inner.count, int)
    for g in grads[2 * K:]:
        sj = step(sj, {k: jnp.asarray(v) for k, v in g.items()})
        st = at.train_step(ct, st, {k: torch.from_numpy(v)
                                    for k, v in g.items()})
    jl = _jax_leaves(sj)
    for key, got in _port_leaves(st).items():
        if isinstance(got, int):
            assert got == int(jl[key]), key
            continue
        atol = 1e-5 / (K * LR) if key.startswith("delta") else 1e-5
        np.testing.assert_allclose(got.numpy(), jl[key], rtol=1e-5,
                                   atol=atol, err_msg=key)
    d2 = str(tmp_path / "port")
    tck.save(d2, st, meta={"step": st.step})
    _assert_bitwise(st, jck.restore(d2, sj))
    jck.save(str(tmp_path / "jax2"), sj)
    assert _file_index(d2) == _file_index(str(tmp_path / "jax2"))


# ---------------------------------------------------------------- resharding
RESHARD = [(4, 3, ""), (2, 5, ""), (4, 2, ""), (4, 3, "int8+overlap"),
           (2, 5, "int8+overlap"), (4, 2, "int8+overlap"),
           (4, 3, "bf16 delta")]


@pytest.mark.parametrize("w_old,w_new,extra", RESHARD)
def test_restore_resharded_bitwise_reference(tmp_path, w_old, w_new, extra):
    kw = dict(algorithm="bvr_l_sgd", inner_optimizer="momentum",
              momentum=0.9)
    if "int8" in extra:
        kw.update(compress="int8", overlap=True)
    if "bf16" in extra:
        kw.update(delta_dtype="bfloat16")
    cj, ct = _cfgs(**kw)
    ej, et = _engines(cj, ct)
    p0 = _params0()
    sj = ej.init({k: jnp.asarray(v) for k, v in p0.items()}, w_old)
    if "bf16" in extra:
        # plant non-zero-sum Δ and B (bf16) to recentre
        rng = np.random.RandomState(2)
        sj = sj._replace(**{f: jnp.asarray(rng.randn(
            *sj.params.shape).astype(np.float32)).astype(jnp.bfloat16)
            for f in ("delta", "bias")})
    else:
        rnd = jax.jit(ej.round_step_flat)
        for r in range(2):
            sj = rnd(sj, jnp.asarray(_grads(ej.spec, (w_old,), K, 20 + r)))
        # and one local step, so Δ is not at a sync
        sj = jax.jit(ej.local_step)(sj, jflat.unflatten_stacked(
            ej.spec, jnp.asarray(_grads(ej.spec, (w_old,), 1, 30)[0])))
    d = str(tmp_path / "ck")
    _save_jax(d, ej, cj, sj, int(sj.step))
    assert tck.saved_workers(d) == w_old
    comps_j, comps_t = (jcc.pair_meta(ej.compressors),
                        tcc.pair_meta(et.compressors))
    want = jck.restore_resharded(d, ej.init({k: jnp.zeros(s) for k, s in
                                             TEMPLATE.items()}, w_new),
                                 ej.spec, compressors=comps_j,
                                 moments=jck.moments_meta(cj))
    got = tck.restore_resharded(
        d, et.init({k: torch.zeros(s) for k, s in TEMPLATE.items()}, w_new),
        et.spec, compressors=comps_t, moments=tck.moments_meta(ct))
    _assert_bitwise(got, want)
    for j in range(w_new):
        np.testing.assert_array_equal(got.params[j].numpy(),
                                      np.asarray(sj.params)[j % w_old])
    for f in ("delta", "bias"):
        buf = getattr(got, f).to(torch.float64)
        tol = (2.0 ** -8 if "bf16" in extra else 1e-6) * float(
            buf.abs().max())
        assert float(buf.sum(0).abs().max()) <= w_new * tol, f
    if "int8" in extra:
        assert float(got.comm.resid.abs().max()) == 0.0
        np.testing.assert_array_equal(got.overlap.pend.numpy(),
                                      got.params.numpy())
        assert float(got.overlap.pend_k.min()) == 1.0
    assert got.step == int(sj.step)
    # and it trains on
    st = et.round_step_flat(got, torch.from_numpy(
        _grads(et.spec, (w_new,), K, 40))) if "bf16" not in extra else got
    assert torch.isfinite(st.params).all()


# ------------------------------------------------- the reference's own cases
def test_roundtrip_tree_and_ints(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "h": torch.arange(6.0).to(torch.bfloat16), "n": 7}
    tck.save(str(tmp_path / "t"), tree, meta={"step": 7})
    out = tck.restore(str(tmp_path / "t"), tree)
    for (k1, l1), (k2, l2) in zip(tm.state_leaves(tree),
                                  tm.state_leaves(out)):
        assert k1 == k2
        np.testing.assert_array_equal(_bits(l1), _bits(l2))
    assert out["n"] == 7 and out["h"].dtype == torch.bfloat16
    assert tck.load_meta(str(tmp_path / "t"))["meta"]["step"] == 7
    # the JAX package reads it: bf16 re-viewed from the raw V2 bytes
    back = jck.restore(str(tmp_path / "t"), {
        "a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros(5, jnp.int32)},
        "h": jnp.zeros(6, jnp.bfloat16), "n": jnp.zeros((), jnp.int32)})
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["h"], np.float32),
                                  np.arange(6.0))


def test_shape_and_dtype_mismatch_raise(tmp_path):
    tck.save(str(tmp_path / "m"), {"a": torch.ones(2, 2)})
    with pytest.raises(ValueError, match=r"a: shape \(2, 2\) != template"):
        tck.restore(str(tmp_path / "m"), {"a": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="a: dtype float32 != template "
                       "bfloat16"):
        tck.restore(str(tmp_path / "m"),
                    {"a": torch.ones(2, 2, dtype=torch.bfloat16)})
    with pytest.raises(KeyError, match="missing 'b'"):
        tck.restore(str(tmp_path / "m"), {"a": torch.ones(2, 2),
                                          "b": torch.ones(1)})


def _engine_state(ct, w, rounds=2):
    et = teng.make_engine(ct, {k: torch.empty(s, device="meta")
                               for k, s in TEMPLATE.items()})
    st = et.init({k: torch.from_numpy(v) for k, v in _params0().items()}, w)
    lead = tuple(et.grid) if et.grid is not None else (w,)
    for r in range(rounds):
        st = et.round_step_flat(st, torch.from_numpy(
            _grads(et.spec, lead, K, 50 + r)))
    return et, st


def test_flat_state_residuals_and_compressor_refusals(tmp_path):
    _, ct = _cfgs(compress="int8")
    et, st = _engine_state(ct, 3)
    assert float(st.comm.resid.abs().max()) > 0.0
    meta = tcc.pair_meta(et.compressors)
    d = str(tmp_path / "f")
    with pytest.raises(ValueError, match="no compressor metadata"):
        tck.save_flat_state(d, st, et.spec)
    tck.save_flat_state(d, st, et.spec, meta={"step": 4}, compressors=meta)
    out = tck.restore_flat_state(d, st, et.spec, compressors=meta)
    np.testing.assert_array_equal(out.comm.resid.numpy(),
                                  st.comm.resid.numpy())
    with pytest.raises(ValueError, match="compressor"):
        tck.restore_flat_state(d, st, et.spec, compressors=None)
    _, ct0 = _cfgs()
    et0, s0 = _engine_state(ct0, 3, rounds=0)
    tck.save_flat_state(str(tmp_path / "u"), s0, et0.spec,
                        compressors=tcc.pair_meta(et0.compressors))
    with pytest.raises(ValueError, match="sync compressors do not match"):
        tck.restore_flat_state(str(tmp_path / "u"), s0, et0.spec,
                               compressors=meta)


def test_layout_and_moment_refusals(tmp_path):
    _, ct = _cfgs(**CASES["adam+sm3+bf16, 2 shards"])
    et, st = _engine_state(ct, 2)
    assert st.inner.mu.dtype == torch.bfloat16
    moments = tck.moments_meta(ct)
    assert moments == {"moment_dtype": "bfloat16", "sm3": True}
    d = str(tmp_path / "q")
    tck.save_flat_state(d, st, et.spec, meta={"step": 4}, moments=moments)
    out = tck.restore_flat_state(d, st, et.spec, moments=moments)
    for (k1, a), (k2, b) in zip(tm.state_leaves(st), tm.state_leaves(out)):
        assert k1 == k2 and type(a) is type(b)
        assert _bits(a).dtype == _bits(b).dtype, k1
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k1)
    ct2 = dataclasses.replace(ct, engine=TEC(block=8, shards=4))
    et2, s2 = _engine_state(ct2, 2, rounds=0)
    with pytest.raises(ValueError, match="flat-buffer layout"):
        tck.restore_flat_state(d, s2, et2.spec,
                               moments=tck.moments_meta(ct2))
    ct3 = dataclasses.replace(ct, moment_dtype="float32", sm3=False)
    with pytest.raises(ValueError, match="moment storage"):
        tck.restore_flat_state(d, st, et.spec,
                               moments=tck.moments_meta(ct3))


def test_grid_mismatch_and_wrong_worker_count_refused(tmp_path):
    _, ct = _cfgs(algorithm="hier_vrl_sgd", hier=HIER)
    et, st = _engine_state(ct, 4, rounds=1)
    d = str(tmp_path / "h")
    tck.save_flat_state(d, st, et.spec, grid=et.grid)
    with pytest.raises(ValueError, match=r"worker grid \[2, 2\] does not "
                       r"match the engine's grid \[4, 1\]"):
        tck.restore_flat_state(d, st, et.spec, grid=(4, 1))
    with pytest.raises(ValueError, match="hierarchical"):
        tck.restore_resharded(d, st, et.spec)
    _, ct = _cfgs()
    et, s4 = _engine_state(ct, 4, rounds=0)
    tck.save_flat_state(str(tmp_path / "w4"), s4, et.spec)
    s6 = et.init({k: torch.from_numpy(v) for k, v in _params0().items()}, 6)
    with pytest.raises(ValueError, match=r"\(4,.*\(6,"):
        tck.restore_flat_state(str(tmp_path / "w4"), s6, et.spec)
    _, ctc = _cfgs(compress="int8")
    etc = teng.make_engine(ctc, {k: torch.empty(s, device="meta")
                                 for k, s in TEMPLATE.items()})
    sc = etc.init({k: torch.zeros(s) for k, s in TEMPLATE.items()}, 6)
    with pytest.raises(ValueError, match="compressor"):
        tck.restore_resharded(str(tmp_path / "w4"), sc, etc.spec,
                              compressors=tcc.pair_meta(etc.compressors))


def test_torn_write_preserves_previous_checkpoint(tmp_path):
    d = str(tmp_path / "a")
    v1 = {"a": torch.arange(6.0).reshape(2, 3)}
    v2 = {"a": torch.arange(6.0).reshape(2, 3) * 10}
    tck.save(d, v1, meta={"step": 1})
    with pytest.raises(tck.SimulatedKill, match="mid-write"):
        with tck.kill_save("mid-write"):
            tck.save(d, v2, meta={"step": 2})
    np.testing.assert_array_equal(tck.restore(d, v1)["a"].numpy(),
                                  v1["a"].numpy())
    assert tck.load_meta(d)["meta"]["step"] == 1
    assert glob.glob(os.path.join(d, "arrays.npz.tmp.*"))
    with pytest.raises(tck.SimulatedKill, match="pre-rename"):
        with tck.kill_save("pre-rename"):
            tck.save(d, v2, meta={"step": 2})
    assert tck.load_meta(d)["meta"]["step"] == 1
    tck.save(d, v2, meta={"step": 2})
    assert not glob.glob(os.path.join(d, "arrays.npz.tmp.*"))
    np.testing.assert_array_equal(tck.restore(d, v1)["a"].numpy(),
                                  v2["a"].numpy())
    with pytest.raises(ValueError, match="unknown kill_save phase"):
        with tck.kill_save("later"):
            pass


def test_save_step_latest_and_retention(tmp_path):
    root = str(tmp_path / "run")
    tree = {"a": torch.ones(2)}
    for step in (2, 4, 6):
        tck.save_step(root, step, lambda p, s=step: tck.save(
            p, tree, meta={"step": s}), retain=2)
    step, path = tck.latest_step(root)
    assert step == 6 and path == tck.step_dir(root, 6)
    assert tck.load_meta(path)["meta"]["step"] == 6
    assert not os.path.exists(tck.step_dir(root, 2))
    assert os.path.exists(tck.step_dir(root, 4))
    with pytest.raises(tck.SimulatedKill):
        with tck.kill_save("mid-write"):
            tck.save_step(root, 8, lambda p: tck.save(p, tree))
    assert tck.latest_step(root)[0] == 6
    os.remove(os.path.join(root, "latest"))
    assert tck.latest_step(root)[0] == 6
    with open(os.path.join(root, "latest"), "w") as f:
        f.write("ckpt-00000099")
    assert tck.latest_step(root)[0] == 6
    assert tck.latest_step(str(tmp_path / "nowhere")) is None


def test_repartition_covers_every_index_once():
    labels = np.repeat(np.arange(10), 20)
    parts = class_shard_partition(labels, 4, seed=0)
    for w_new in (3, 4, 6):
        newp = repartition(parts, w_new)
        assert len(newp) == w_new
        allidx = np.concatenate(newp)
        assert len(allidx) == len(labels)
        assert len(np.unique(allidx)) == len(labels)
    with pytest.raises(ValueError, match=">= 1"):
        repartition(parts, 0)


# ----------------------------------------------------------------- the CLI
SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--workers",
         "2", "--batch", "2", "--seq", "32", "--k", "2", "--lr", "0.05"]


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as f:
        return {k: f[k] for k in f.files if k != "__meta__"}


@pytest.mark.parametrize("extra", [[], ["--compress", "int8", "--overlap"],
                                   ["--no-round"]])
def test_cli_resume_is_bitwise_the_uninterrupted_run(tmp_path, extra):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = t_launch.run(SMOKE + extra + ["--steps", "6", "--ckpt", a,
                                         "--ckpt-every", "2"])
    assert sorted(os.listdir(a)) == ["ckpt-00000002", "ckpt-00000004",
                                     "ckpt-00000006", "latest"]
    res = t_launch.run(SMOKE + extra + [
        "--steps", "6", "--ckpt", b, "--ckpt-every", "2", "--resume",
        os.path.join(a, "ckpt-00000002")])
    assert res.start_step == 2
    assert res.losses == full.losses[2:]
    assert res.avg_model_losses[-1] == full.avg_model_losses[-1]
    want, got = _npz(tck.step_dir(a, 6)), _npz(tck.step_dir(b, 6))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_resume_auto_and_past_the_end(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    fresh = t_launch.run(SMOKE + ["--steps", "4", "--ckpt", ck,
                                  "--ckpt-every", "2", "--resume", "auto"])
    assert "no complete checkpoint — fresh start" in capsys.readouterr().out
    assert fresh.start_step == 0 and len(fresh.losses) == 4
    lo = str(tmp_path / "loss.json")
    res = t_launch.run(SMOKE + ["--steps", "2", "--ckpt", ck,
                                "--resume", "auto", "--loss-out", lo])
    assert res.start_step == 4 and res.losses == []
    out = json.load(open(lo))
    assert out["steps"] == 4 and np.isfinite(out["avg_model_loss"])
    assert "nothing to do" in capsys.readouterr().out
    # the restored model, evaluated: the state is the step-4 checkpoint's
    np.testing.assert_array_equal(res.state.params.numpy(),
                                  fresh.state.params.numpy())


@pytest.mark.parametrize("flags, msg", [
    (["--ckpt-every", "0"], "--ckpt-every must be a positive step count"),
    (["--ckpt-retain", "-1"], "--ckpt-retain must be >= 0"),
    (["--resume", "auto"], "--resume auto finds checkpoints under --ckpt"),
    (["--resume", "/nonexistent/ckpt-00000002"], "--resume /nonexistent"),
])
def test_cli_checkpoint_flag_refusals(flags, msg):
    with pytest.raises(SystemExit, match=msg):
        t_launch.run(SMOKE + ["--steps", "2"] + flags)


def test_cli_resume_reshards_a_changed_worker_count(tmp_path, capsys):
    """W = 4 saved, W = 3 resumed: the state resharded, the data
    assignment's four shards re-split over three workers (the reference
    refuses fewer shards than workers, as here)."""
    ck = str(tmp_path / "ck")
    argv = list(SMOKE)
    argv[argv.index("--workers") + 1] = "4"
    t_launch.run(argv + ["--steps", "4", "--ckpt", ck, "--ckpt-every", "2"])
    argv[argv.index("--workers") + 1] = "3"
    res = t_launch.run(argv + ["--steps", "6", "--resume",
                               tck.step_dir(ck, 2)])
    out = capsys.readouterr().out
    assert "resharding 4 -> 3 workers" in out
    assert "re-splitting saved data assignment 4 -> 3" in out
    assert res.state.params.shape[0] == 3
    assert all(np.isfinite(res.losses)) and len(res.losses) == 4


def test_cli_growing_past_the_saved_shards_is_refused_as_in_the_reference(
        tmp_path, capsys):
    """W = 2 saved, W = 4 resumed: the state reshards, but the saved data
    assignment holds two shards, which do not split over four workers —
    the reference's CLI refuses it (a ValueError from
    ``data.partition.repartition``), the port's exits with that message."""
    from repro.launch import train as j_launch
    ck = str(tmp_path / "ck")
    t_launch.run(SMOKE + ["--steps", "2", "--ckpt", ck, "--ckpt-every", "2"])
    argv = list(SMOKE)
    argv[argv.index("--workers") + 1] = "4"
    argv += ["--steps", "4", "--resume", tck.step_dir(ck, 2)]
    msg = "cannot give every worker an index: 2 indices < 4 workers"
    with pytest.raises(SystemExit, match=msg):
        t_launch.run(argv)
    assert "resharding 2 -> 4 workers" in capsys.readouterr().out
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(ValueError, match=msg):
        j_launch.main(jargv + ["--backend", "xla"])
    assert "resharding 2 -> 4 workers" in capsys.readouterr().out


# ------------------------------------------------------- the CLI on a mesh
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_run(argv, out, world=2):
    tmp.start_processes(R.cli, args=(world, _free_port(), argv, out),
                        nprocs=world, start_method="spawn")
    return [torch.load(f"{out}.rank{r}", weights_only=False)
            for r in range(world)]


@pytest.mark.parametrize("extra", [["--workers", "2"],
                                   ["--workers", "4", "--algorithm",
                                    "hier_vrl_sgd", "--pods", "2", "--k1",
                                    "2", "--k2", "4", "--compress", "int8",
                                    "--overlap"]])
def test_cli_mesh_save_and_resume_across_worlds(tmp_path, extra):
    """World 2 saves, one process resumes; one process saves, world 2
    resumes: each continues the one-process run bitwise (every checkpoint
    leaf), and the mesh's rounds keep one model-state all-reduce per level
    each.  The reported losses are bitwise too at W = 2; over the (2, 2)
    grid the loss's worker mean sums two ranks' partial sums, (a + b) +
    (c + d), where one process sums four in a row, so they agree to its
    rounding (the state, which the losses do not feed, stays bitwise)."""
    argv = SMOKE + extra + ["--steps", "8", "--ckpt-every", "4"]
    hier = "hier_vrl_sgd" in extra

    def same_losses(got, want):
        if hier:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert got == want
    one = t_launch.run(argv + ["--ckpt", str(tmp_path / "one")])
    mesh = _mesh_run(argv + ["--ckpt", str(tmp_path / "mesh"),
                             "--mesh-grid"], str(tmp_path / "m"))
    for d in ("one", "mesh"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "ckpt-00000004", "ckpt-00000008", "latest"]
    # the mesh's one file is the one process's file, bitwise
    for step in (4, 8):
        want = _npz(tck.step_dir(str(tmp_path / "one"), step))
        got = _npz(tck.step_dir(str(tmp_path / "mesh"), step))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for res in mesh:
        same_losses(res["losses"], one.losses)
        counts = res["collectives"]
        state = counts["state"]
        if hier:
            assert state["data"]["calls"] == 4 and state["pod"]["calls"] == 2
        else:
            assert state["pod+data"]["calls"] == 4
        assert counts["checkpoint"]["pod+data"]["calls"] > 0
    # one process resumes the mesh's step-4 file ...
    res = t_launch.run(argv + ["--ckpt", str(tmp_path / "r1"), "--resume",
                               tck.step_dir(str(tmp_path / "mesh"), 4)])
    assert res.losses == one.losses[4:]          # one process: bitwise
    # ... and world 2 resumes the one process's
    mesh2 = _mesh_run(argv + ["--ckpt", str(tmp_path / "r2"), "--resume",
                              tck.step_dir(str(tmp_path / "one"), 4),
                              "--mesh-grid"], str(tmp_path / "m2"))
    for res in mesh2:
        same_losses(res["losses"], one.losses[4:])
    for d in ("r1", "r2"):
        want = _npz(tck.step_dir(str(tmp_path / "one"), 8))
        got = _npz(tck.step_dir(str(tmp_path / d), 8))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(d, k))


# ---------------------------------------------------------------- example
def test_train_lm_e2e_example_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.examples import train_lm_e2e as ex
    ck = str(tmp_path / "e2e")
    argv = ["--device", "cpu", "--steps", "4", "--workers", "2", "--k", "2",
            "--batch", "2", "--seq", "16", "--ckpt", ck, "--ckpt-every", "2"]
    first = ex.main(argv)
    out = capsys.readouterr().out
    assert "checkpoint ->" in out and "final avg-model ppl" in out
    assert np.isfinite(first["ppl"])
    again = ex.main(argv[:argv.index("--steps") + 1] + ["6"]
                    + argv[argv.index("--steps") + 2:] + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed step 4" in out and again["steps"] == 6
    assert np.isfinite(again["ppl"])
