"""PyTorch port, the whole training slice vs the JAX package.

* ``make_train_step`` (per-worker forward/backward into the flat gradient
  buffer, fused local steps, worker mean + fused sync) against the JAX
  ``make_train_step(update_backend="xla")``: W=2, k=2, batch 2, seq 16,
  γ=0.05, VRL-SGD-W warmup, rounds of 1, 2, 2, 2 on the reference's token
  stream, both free-running from the same parameters.

  Those parameters are the reference's init with wq and wk scaled by 0.1.
  The init rule takes fan-in as the head count, so at face value the
  attention scores are in the hundreds, softmax is nearly one-hot over
  near-tied keys of sorted token runs, and a 1e-6 parameter difference
  grows ~1e4-fold in the next gradient: two fp32 implementations (or the
  reference's own two executors, see ``.claude/skills/verify/SKILL.md``)
  part within a round.  With softer attention the map is smooth and the
  two packages agree to fp32 rounding, so the tolerances can be tight:
  per-step losses rtol 1e-5; final params atol 1e-5 and Δ atol
  1e-5/(k·γ) (the reference's engine standard); one step's gradients
  1e-5 of each leaf's max.
* The port's token stream is bitwise the reference's.
* ``launch.train`` runs with ``--device cpu``; without ``--device`` on a
  machine with no CUDA device it fails rather than fall back to the CPU.
* Importing every ``repro_torch`` module pulls in neither ``jax`` nor
  ``repro``.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.data import assigned_token_stream as j_stream  # noqa: E402
from repro.data import contiguous_assignment as j_assign  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.loss import cross_entropy_lm as j_ce  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core.types import FlatWorkerState  # noqa: E402
from repro_torch.data import assigned_token_stream as t_stream  # noqa: E402
from repro_torch.data import contiguous_assignment as t_assign  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.loss import cross_entropy_lm as t_ce  # noqa: E402
from repro_torch.train.train_loop import make_train_step as t_make  # noqa: E402

W, B, S, K, LR = 2, 2, 16, 2, 0.05
CFG_J, CFG_T = jreg.smoke_arch("qwen2-0.5b"), treg.smoke_arch("qwen2-0.5b")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


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
def bundles():
    cfg_j, cfg_t = CFG_J, CFG_T
    jb = j_make(cfg_j, JVRL(comm_period=K, learning_rate=LR, warmup=True,
                            update_backend="xla"), remat=False)
    tb = t_make(cfg_t, TVRL(comm_period=K, learning_rate=LR, warmup=True),
                device="cpu")
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    return jb, tb, params, cfg_j


def _tok(a):
    return torch.from_numpy(np.array(a)).long()


def _to_port(js):
    """The port's engine state holding exactly the JAX state's values."""
    return FlatWorkerState(params=torch.from_numpy(np.array(js.params)),
                           delta=torch.from_numpy(np.array(js.delta)),
                           step=int(js.step), last_sync=int(js.last_sync))


def test_token_stream_bitwise_reference():
    for identical in (False, True):
        for units in (1, 2, 4):
            args = dict(steps=5, batch=3, alpha=0.05, identical=identical,
                        seed=7)
            want = j_stream(j_assign(units, units), 16, 512, **args)
            got = t_stream(t_assign(units, units), 16, 512, **args)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for n, u in ((8, 3), (5, 5)):
        for a, b in zip(t_assign(n, u), j_assign(n, u)):
            np.testing.assert_array_equal(a, b)


def test_slice_matches_reference(bundles):
    jb, tb, params, cfg_j = bundles
    js = jb.engine.init(params, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, params)), W)
    steps = 7
    data = j_stream(j_assign(W, W), S, cfg_j.vocab_size, steps=steps,
                    batch=B, alpha=0.05, seed=0)
    round_j = jax.jit(jb.round_step)
    t = 0
    for rk in (1, K, K, K):
        toks = data[t:t + rk]
        labels = np.roll(toks, -1, axis=-1)
        js, lj = round_j(js, jnp.asarray(toks), jnp.asarray(labels))
        ts, lt = tb.round_step(ts, _tok(toks), _tok(labels))
        t += rk
        assert lt.shape == (rk,)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
        assert (ts.step, ts.last_sync) == (int(js.step), int(js.last_sync))
    assert t == steps
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.delta.numpy(), np.asarray(js.delta),
                               rtol=0, atol=1e-5 / (K * LR))
    # the evaluation model and its loss (launch.train's avg_model_loss)
    avg_j = jb.average_model(js)
    avg_t = tb.average_model(ts)
    toks = data[-1].reshape(-1, S)
    el_j = float(j_ce(JT.forward(cfg_j, avg_j, jnp.asarray(toks))[0],
                      jnp.asarray(np.roll(toks, -1, axis=-1))))
    with torch.no_grad():
        el_t = t_ce(TT.forward(CFG_T, avg_t, _tok(toks)),
                    _tok(np.roll(toks, -1, axis=-1))).item()
    np.testing.assert_allclose(el_t, el_j, rtol=1e-5)


def test_grads_fn_matches_reference(bundles):
    """One step's per-worker gradients (into the flat buffer) and mean
    loss, from the same state: gradients to 1e-5 of each leaf's max, loss
    rtol 1e-6."""
    jb, tb, params, cfg_j = bundles
    js = jb.engine.init(params, W)
    data = j_stream(j_assign(W, W), S, cfg_j.vocab_size, steps=1, batch=B,
                    alpha=0.05, seed=1)
    toks, labels = data[0], np.roll(data[0], -1, axis=-1)
    # distinct workers: perturb worker 1 so a swapped slot would show
    js = js._replace(params=js.params.at[1].multiply(1.01))
    gj, lj = jax.jit(jb.grads_fn)(js, jnp.asarray(toks), jnp.asarray(labels))
    gj = np.asarray(jflat.flatten_stacked(jb.engine.spec, gj))
    gt, lt = tb.grads_fn(_to_port(js), _tok(toks), _tok(labels))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    gt = gt.numpy()
    for leaf in tb.engine.spec.leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        a, b = gj.reshape(W, -1)[:, sl], gt.reshape(W, -1)[:, sl]
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * np.abs(a).max() + 1e-12,
                                   err_msg=leaf.path)
    # the pad tail carries no gradient
    assert not gt.reshape(W, -1)[:, tb.engine.spec.size:].any()


def test_launch_train_runs_on_cpu(capsys):
    res = t_launch.run(["--smoke", "--device", "cpu", "--workers", "2",
                        "--steps", "4", "--k", "2", "--batch", "2",
                        "--seq", "16", "--lr", "0.05", "--warmup",
                        "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    # rounds of 1 and 2, then a one-step tail on the per-step cadence
    assert [l.split(")")[0] for l in out if l.startswith("step")] == [
        "step     1 (round 1", "step     3 (round 2", "step     4 (tail"]
    assert out[-1].startswith("kernels: ")
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    assert (res.state.step, res.state.last_sync) == (4, 3)
    assert t_launch.main(["--smoke", "--device", "cpu", "--workers", "1",
                          "--steps", "2", "--k", "1", "--batch", "1",
                          "--seq", "8", "--profile-round", "2"]) == 0
    out = capsys.readouterr().out
    assert "profile: round of 1 steps" in out


def test_launch_train_needs_cuda_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(SystemExit, match="no CUDA device"):
        t_launch.run(["--smoke", "--steps", "1"])


def test_launch_train_refuses_unported_algorithm():
    """Every algorithm and option of the core flags is ported: hier_vrl_sgd
    runs with ``--compress`` (its runs: ``tests/test_torch_hier_compress
    .py``); what the CLI refuses is what the reference's refuses —
    ``--compress2`` without the hierarchy, a deadline outside [0, 1], a
    deadline without overlap."""
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--workers", "2",
            "--batch", "1", "--seq", "8"]
    res = t_launch.run(argv + ["--algorithm", "hier_vrl_sgd", "--pods", "1",
                               "--compress", "int8"])
    assert res.engine.compressors[0].name == "int8"
    for bad, why in ((["--compress2", "int8"], "--compress2"),
                     (["--overlap", "--deadline", "-0.1"], "--deadline"),
                     (["--deadline", "0.5"], "overlap")):
        with pytest.raises(SystemExit, match=why):
            t_launch.run(argv + bad)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.comm.compressors' in sys.modules\n"
        "for m in ('checkpoint.checkpoint', 'checkpoint.reshard', "
        "'obs.metrics', 'obs.diagnostics', 'obs.report', 'obs.convert', "
        "'obs.timers', 'examples.train_lm_e2e', 'fault.schedule', "
        "'core.clients', 'examples.quickstart', "
        "'examples.federated_nonidentical'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


TRAIN_CASES = [("bvr_l_sgd", "adam", 0.0), ("easgd", "momentum", 0.0),
               ("ssgd", "sgd", 1.0)]


@pytest.mark.parametrize("alg,inner,clip", TRAIN_CASES)
def test_slice_other_algorithms_match_reference(alg, inner, clip):
    """``make_train_step`` for the other algorithms and inner optimizers
    (``clip_norm`` on S-SGD) against the reference's, free-running from
    the same softened start: per-step losses rtol 1e-5; final params atol
    1e-5, Δ, B and the first moment atol 1e-5/(k·γ), EASGD's center atol
    1e-5.

    Adam's step γ·m̂/√v̂ has the size γ whatever the size of v: a gradient
    element that is a cancelling sum (true value ≈ 0, fp32 noise above
    eps = 1e-8) takes a ±γ step whose sign is the noise's, so the two
    packages' gradients — equal to fp32 rounding, summed in other orders —
    part by up to γ per step there.  For adam the params and state are
    held to atol 1e-5 on all but 1 % of the elements (0.17 % measured),
    and to 2γ per step on every element."""
    lr = 1e-3 if inner == "adam" else LR
    kw = dict(algorithm=alg, comm_period=K, learning_rate=lr, warmup=True,
              inner_optimizer=inner, clip_norm=clip,
              momentum=0.9 if inner == "momentum" else 0.0)
    jb = j_make(CFG_J, JVRL(update_backend="xla", **kw), remat=False)
    tb = t_make(CFG_T, TVRL(**kw), device="cpu")
    params = JT.init_params(CFG_J, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    js = jb.engine.init(params, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, params)), W)
    data = j_stream(j_assign(W, W), S, CFG_J.vocab_size, steps=7, batch=B,
                    alpha=0.05, seed=0)
    round_j = jax.jit(jb.round_step)
    t = 0
    for rk in (1, K, K, K):
        toks = data[t:t + rk]
        labels = np.roll(toks, -1, axis=-1)
        js, lj = round_j(js, jnp.asarray(toks), jnp.asarray(labels))
        ts, lt = tb.round_step(ts, _tok(toks), _tok(labels))
        t += rk
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
        assert (ts.step, ts.last_sync) == (int(js.step), int(js.last_sync))
    scaled = 1e-5 / (K * lr)
    pairs = [(ts.params, js.params, 1e-5, 2 * lr * 7),
             (ts.delta, js.delta, scaled, 2 * 7 / K),
             (ts.bias, js.bias, scaled, 2 * 7 / K)]
    if inner == "momentum":
        pairs.append((ts.inner, js.inner, scaled, None))
    if inner == "adam":
        pairs.append((ts.inner.mu, js.inner.mu, scaled, 1.0))
        assert ts.inner.count == int(js.inner.count) == 7
    for a, b, atol, bound in pairs:
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape")
        if not isinstance(a, torch.Tensor):
            continue
        if inner != "adam":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=atol)
            continue
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff > atol).mean() <= 0.01, (diff > atol).mean()
        assert diff.max() <= bound
    if alg == "easgd":
        np.testing.assert_allclose(ts.center.numpy(), np.asarray(js.center),
                                   rtol=0, atol=1e-5)


def test_clip_by_global_norm_matches_reference():
    from repro.train.train_loop import clip_by_global_norm as j_clip
    from repro_torch.train.train_loop import clip_by_global_norm as t_clip
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(4, 3).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32)}}
    for max_norm in (0.5, 1e3):
        want = j_clip(tree, max_norm)
        got = t_clip(from_numpy(tree), max_norm)
        for a, b in zip(jax.tree.leaves(want), [got["a"], got["b"]["c"]]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        as_list = t_clip([torch.from_numpy(tree["a"]),
                          torch.from_numpy(tree["b"]["c"])], max_norm)
        assert torch.equal(as_list[0], got["a"])


def test_clip_root_is_bitwise_reference():
    """The global norm's root is correctly rounded (``sqrt_rn``), as XLA's
    is: on equal sums of squares (two-element trees, whose a² + b² both
    packages round alike) every clipped value is bitwise the reference's,
    for 400 norms over twelve decades (the CPU ``torch.sqrt`` of torch
    2.13 misses 6 of them).  Over many elements the two packages sum the
    squares in other orders, so there the norm stays a tolerance matter
    (``test_clip_by_global_norm_matches_reference``)."""
    from repro.train.train_loop import clip_by_global_norm as j_clip
    from repro_torch.train.train_loop import clip_by_global_norm as t_clip
    rng = np.random.RandomState(11)
    g = (np.exp(rng.uniform(-14.0, 14.0, (400, 2)))
         * np.sign(rng.randn(400, 2))).astype(np.float32)
    # one tree per call, as the train loop clips one worker's gradients
    # (XLA's vectorised sqrt over a vmapped batch is not correctly rounded)
    want = np.stack([np.asarray(j_clip({"a": jnp.asarray(x)}, 1.0)["a"])
                     for x in g])
    got = np.stack([t_clip({"a": torch.from_numpy(g[i])}, 1.0)["a"].numpy()
                    for i in range(len(g))])
    # the root decides the scale wherever the norm exceeds 1
    assert (np.hypot(g[:, 0], g[:, 1]) > 1.0).sum() > 150
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("alg", ["local_sgd", "ssgd", "easgd", "stl_sgd",
                                 "bvr_l_sgd", "vrl_sgd"])
def test_launch_train_every_flat_algorithm_on_cpu(capsys, alg):
    res = t_launch.run(["--smoke", "--device", "cpu", "--workers", "2",
                        "--steps", "5", "--k", "2", "--batch", "2",
                        "--seq", "16", "--lr", "0.05", "--warmup",
                        "--log-every", "1", "--algorithm", alg])
    out = capsys.readouterr().out.splitlines()
    rounds = [l.split(")")[0] for l in out if l.startswith("step")]
    # warmup's 1-step first round for the warmup-aware algorithms; stl_sgd
    # runs its doubling schedule 1, 1, 1, 1, 2 (which supersedes warmup)
    want = {"vrl_sgd": ["step     1 (round 1", "step     3 (round 2",
                        "step     5 (round 3"],
            "stl_sgd": ["step     1 (round 1", "step     2 (round 2",
                        "step     3 (round 3", "step     4 (round 4",
                        "step     5 (tail"]}
    want["bvr_l_sgd"] = want["vrl_sgd"]
    assert rounds == want.get(alg, ["step     2 (round 1",
                                    "step     4 (round 2",
                                    "step     5 (tail"])
    assert len(res.losses) == 5 and np.all(np.isfinite(res.losses))
    n_inv = len(rounds) if alg in ("vrl_sgd", "bvr_l_sgd") else 0
    assert len(res.invariant) == n_inv
    assert len(res.bias_invariant) == (n_inv if alg == "bvr_l_sgd" else 0)
    assert all(s <= 1e-4 * m for _, s, m in
               res.invariant + res.bias_invariant)
    assert out[-1].startswith("kernels: ")
    if alg == "stl_sgd":
        assert "comm schedule: stages ((1, 4), (2, 4))" in "\n".join(out)


SLICE_COMM_CASES = [("vrl_sgd", "int8", False), ("bvr_l_sgd", "topk:32", True),
                    ("vrl_sgd", None, True), ("local_sgd", "int8", True)]


@pytest.mark.parametrize("alg,compress,overlap", SLICE_COMM_CASES)
def test_slice_compressed_overlapped_matches_reference(alg, compress,
                                                       overlap):
    """``make_train_step`` with ``compress`` and/or ``overlap`` against the
    reference's, free-running from the same softened start (rounds of 1,
    2, 2, 2): per-step losses rtol 1e-5; final params atol 1e-5, Δ and B
    atol 1e-5/γ, except at most a few elements where an int8 level or a
    top-k pick flipped between the packages' roundings (the free-running
    models' matmuls round apart), each held to twice the summed step of
    its row over the run's communications — one int8 level, or the row's
    kth-largest |payload| (``tests/test_torch_compress.py``).  The
    reference runs its local steps, sync and round_begin/round_fold one by
    one, so the payload of each communication can be read."""
    from repro.comm import compressors as jcc
    from repro_torch.comm import compressors as tcc
    from test_torch_compress import close_or_flipped, step_bound
    kw = dict(algorithm=alg, comm_period=K, learning_rate=LR, warmup=True,
              overlap=overlap)
    jb = j_make(CFG_J, JVRL(update_backend="xla", compress=None if
                            compress is None else
                            jcc.parse_compressor(compress), **kw),
                remat=False)
    tb = t_make(CFG_T, TVRL(compress=None if compress is None else
                            tcc.parse_compressor(compress), **kw),
                device="cpu")
    params = JT.init_params(CFG_J, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    js = jb.engine.init(params, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, params)), W)
    data = j_stream(j_assign(W, W), S, CFG_J.vocab_size, steps=7, batch=B,
                    alpha=0.05, seed=0)
    local_j = jax.jit(jb.local_step)
    ej = jb.engine
    t, bound = 0, 0.0
    rounds = (1, K, K, K) if teng_spec(alg).warmup_aware else (K, K, K)
    for rk in rounds:
        toks = data[t:t + rk]
        labels = np.roll(toks, -1, axis=-1)
        xbar = ej.round_begin(js, rk) if overlap else None
        lj = []
        for i in range(rk):
            js, loss = local_j(js, jnp.asarray(toks[i]),
                               jnp.asarray(labels[i]))
            lj.append(float(loss))
        if compress is not None and not overlap:
            x = np.asarray(js.params) - np.asarray(js.comm.ref)[None]
            bound += step_bound(compress, x + np.asarray(js.comm.resid))
        js = ej.round_fold(js, xbar) if overlap else jb.sync_step(js)
        if compress is not None and overlap:
            bound += step_bound(compress, np.asarray(js.overlap.pend)
                                - np.asarray(xbar)[None]
                                + np.asarray(js.comm.resid))
        ts, lt = tb.round_step(ts, _tok(toks), _tok(labels))
        t += rk
        np.testing.assert_allclose(lt.numpy(), np.array(lj), rtol=1e-5)
        assert (ts.step, ts.last_sync) == (int(js.step), int(js.last_sync))
    pairs = [("params", ts.params, js.params, 1.0)]
    for name in ("delta", "bias"):
        a, b = getattr(ts, name), getattr(js, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape")
        if isinstance(a, torch.Tensor):
            pairs.append((name, a, b, 1 / LR))
    if overlap:
        pairs.append(("pend", ts.overlap.pend, js.overlap.pend, 1.0))
    for name, a, b, scale in pairs:
        n = close_or_flipped(a.numpy(), b, 1e-5 * scale, 2 * bound * scale,
                             name, compress, picks=True)
        print(f"{alg}+{compress}, overlap={overlap}: {name} {n} flipped")


def teng_spec(alg):
    from repro_torch.core import engine as teng
    return teng.get_spec(alg)


def test_launch_train_compress_and_overlap_on_cpu(capsys):
    """``--compress int8 --overlap`` runs at smoke size; blocking
    ``--compress`` logs the EF term beside Σ_i Δ_i, and Σ_i Δ_i moves by
    it to fp32 rounding; refusals exit with the reason."""
    args = ["--smoke", "--device", "cpu", "--workers", "2", "--steps", "6",
            "--k", "2", "--batch", "2", "--seq", "16", "--lr", "0.05",
            "--warmup", "--log-every", "1"]
    res = t_launch.run(args + ["--compress", "int8", "--overlap"])
    out = capsys.readouterr().out
    assert "overlap: sync worker mean taken at round start" in out
    assert "compress: int8 — sync wire 0.52 MiB (4.8x)" in out
    assert [l.split(")")[0] for l in out.splitlines()
            if l.startswith("step")] == [
        "step     1 (round 1", "step     3 (round 2", "step     5 (round 3",
        "step     6 (tail"]
    assert len(res.losses) == 6 and np.all(np.isfinite(res.losses))
    # the tail takes local steps only: the last fold was at step 5
    assert (res.state.step, res.state.last_sync) == (6, 5)
    assert all(s <= 1e-4 * m for _, s, m in res.invariant)
    assert res.ef_identity == []
    res = t_launch.run(args + ["--compress", "topk:8"])
    out = capsys.readouterr().out
    assert out.count("EF term max|sum_i (e_i - e'_i)|/(k lr)") == 3
    assert len(res.ef_identity) == 3
    for (_, ef_t, resid), (_, _, max_d) in zip(res.ef_identity,
                                               res.invariant):
        assert ef_t > 0 and resid <= 1e-4 * max_d
    for bad, why in ((["--compress", "int9"], "--compress"),
                     (["--overlap", "--algorithm", "ssgd"], "overlap")):
        with pytest.raises(SystemExit, match=why):
            t_launch.run(args + bad)
