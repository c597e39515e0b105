"""Checks of a whole smoke model against the JAX package, shared by
``tests/test_torch_moe.py`` (phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b) and
``tests/test_torch_hybrid.py`` (hymba-1.5b): each test file parametrises
its own architectures over these functions.

The JAX parameters are carried across with ``from_numpy``; the same numpy
inputs go through both packages.  Tolerances, as the dense family's
(``tests/test_torch_model.py``, ``test_torch_backbone.py``): logits atol
1e-4; the aux loss rtol 1e-6; the training loss (cross entropy plus
``router_aux_loss`` · aux) rtol 1e-5; gradients per leaf atol 1e-3 ·
max|g|; cache leaves atol 1e-4 · max(1, max|leaf|); prefill against
step-by-step decode 5e-4 (the reference's
``test_prefill_then_decode_continuation``); one engine round at the
engine-parity tolerance (losses rtol 1e-5, params atol 1e-5, Δ atol
1e-5/(k γ)).  The routed experts' combine adds a token's k rows in
another order than the reference's scatter, so none of these is
bitwise; ``remat`` recomputes the same operations, so its gradients are
bitwise those without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.configs.base import VRLConfig as JVRL
from repro.data import assigned_token_stream as j_stream
from repro.data import contiguous_assignment as j_assign
from repro.models import transformer as JT
from repro.train.loss import cross_entropy_lm as j_ce
from repro.train.train_loop import make_train_step as j_make
from repro_torch import tree as tm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import VRLConfig as TVRL
from repro_torch.models import param as tparam
from repro_torch.models import transformer as TT
from repro_torch.models.param import from_numpy
from repro_torch.train.loss import cross_entropy_lm as t_ce
from repro_torch.train.train_loop import make_train_step as t_make

LOGIT_TOL = 1e-4
W, B, S, K, LR = 2, 2, 16, 2, 0.05

_PARAMS: dict = {}


def cfgs(arch):
    return jreg.smoke_arch(arch), treg.smoke_arch(arch)


def params(arch):
    """(JAX params, the same values in the port), drawn once per arch."""
    if arch not in _PARAMS:
        cj, _ = cfgs(arch)
        pj = JT.init_params(cj, jax.random.PRNGKey(0))
        _PARAMS[arch] = pj, from_numpy(jax.tree.map(np.asarray, pj))
    return _PARAMS[arch]


def tokens(cfg, seed=0, b=B, s=S):
    """numpy token ids and their next-token labels."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=-1)


def port(x):
    return torch.from_numpy(np.array(x, copy=True)).long()


def assert_cache(got, want):
    """Leaf by leaf (paths, shapes, dtypes) within atol 1e-4 · max(1,
    max|leaf|)."""
    want = jax.tree.map(np.asarray, want)
    gl, wl = tm.leaves_with_path(got), tm.leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        w32 = w.astype(np.float32)
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w32).max()),
                                   err_msg=path)


def config_matches(arch):
    cj, ct = jreg.get_arch(arch), treg.get_arch(arch)
    assert cj.__dict__ == ct.__dict__
    assert jreg.smoke_arch(arch).__dict__ == treg.smoke_arch(arch).__dict__
    assert jreg.describe(arch) == treg.describe(arch)
    for a, b in ((cj, ct), cfgs(arch)):
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()


def materialised_counts(arch, excess):
    """The tree at full width (meta tensors, nothing allocated) holds the
    reference's analytic count plus ``excess``; at the smoke width the
    port's tree is the reference's, leaf for leaf."""
    cfg = treg.get_arch(arch)
    n = sum(x.numel() for x in tm.leaves(tparam.abstract(TT.model_defs(cfg))))
    assert n == cfg.param_count() + excess
    cj, ct = cfgs(arch)
    want = jax.eval_shape(lambda: JT.init_params(cj, jax.random.PRNGKey(0)))
    got = tparam.abstract(TT.model_defs(ct))
    assert [(p, tuple(x.shape)) for p, x in tm.leaves_with_path(got)] == [
        (p, tuple(x.shape)) for p, x in tm.leaves_with_path(want)]


def logits_and_aux(arch):
    cj, ct = cfgs(arch)
    pj, pt = params(arch)
    toks, _ = tokens(cj)
    lj, aj = JT.forward(cj, pj, jnp.asarray(toks))
    with torch.no_grad():
        lt, at = TT.forward(ct, pt, port(toks), return_aux=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    assert at.dtype == torch.float32 and at.shape == ()
    np.testing.assert_allclose(at.item(), float(aj), rtol=1e-6, atol=1e-7)
    if cj.num_experts:
        assert float(aj) > 0
    else:
        assert float(aj) == at.item() == 0.0
    # without return_aux the logits alone, as every caller before
    with torch.no_grad():
        assert torch.equal(TT.forward(ct, pt, port(toks)), lt)


def _j_loss(cj, p, toks, labels):
    logits, aux = JT.forward(cj, p, jnp.asarray(toks))
    loss = j_ce(logits, jnp.asarray(labels))
    if cj.num_experts:
        loss = loss + cj.router_aux_loss * aux
    return loss


def _t_loss_grads(ct, pt, toks, labels, remat):
    """The port's training loss (``make_train_step``'s ``loss_fn``) and
    its gradients per leaf."""
    pairs = tm.leaves_with_path(pt)
    leaves = [x.clone().requires_grad_() for _, x in pairs]
    p = tm.from_paths([(path, x) for (path, _), x in zip(pairs, leaves)])
    logits, aux = TT.forward(ct, p, port(toks), remat=remat,
                             return_aux=True)
    loss = t_ce(logits, port(labels))
    if ct.num_experts:
        loss = loss + ct.router_aux_loss * aux
    return loss, [(path, g) for (path, _), g in zip(
        pairs, torch.autograd.grad(loss, leaves))]


def loss_and_grads(arch):
    cj, ct = cfgs(arch)
    pj, pt = params(arch)
    toks, labels = tokens(cj, seed=1)
    lj, gj = jax.value_and_grad(lambda p: _j_loss(cj, p, toks, labels))(pj)
    lt, gt = _t_loss_grads(ct, pt, toks, labels, remat=False)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    gj = dict(tm.leaves_with_path(jax.tree.map(np.asarray, gj)))
    assert sorted(gj) == sorted(p for p, _ in gt)
    for path, g in gt:
        want = gj[path]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=path)


def remat_bitwise(arch):
    _, ct = cfgs(arch)
    _, pt = params(arch)
    toks, labels = tokens(ct, seed=2)
    l0, g0 = _t_loss_grads(ct, pt, toks, labels, remat=False)
    l1, g1 = _t_loss_grads(ct, pt, toks, labels, remat=True)
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(g0, g1):
        assert torch.equal(a, b), path


def prefill_and_decode(arch, s=10, cache_len=16):
    """Prefill logits and the cache tree, then teacher-forced decode steps
    from it, against the reference's."""
    cj, ct = cfgs(arch)
    pj, pt = params(arch)
    toks, _ = tokens(cj, seed=3, s=s + 4)
    lj, cache_j = JT.prefill(cj, pj, jnp.asarray(toks[:, :s]), cache_len)
    with torch.no_grad():
        lt, cache_t = TT.prefill(ct, pt, port(toks[:, :s]), cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    assert_cache(cache_t, cache_j)
    step = jax.jit(lambda c, t, pos: JT.decode_step(cj, pj, c, t, pos))
    with torch.no_grad():
        for pos in range(s, s + 4):
            lj, cache_j = step(cache_j, jnp.asarray(toks[:, pos:pos + 1]),
                               pos)
            lt, cache_t = TT.decode_step(ct, pt, cache_t,
                                         port(toks[:, pos:pos + 1]), pos)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                       atol=LOGIT_TOL)
    assert_cache(cache_t, cache_j)


def init_cache_matches(arch, cache_len=16):
    cj, ct = cfgs(arch)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        assert_cache(TT.init_cache(ct, 2, cache_len, dtype=tdt),
                     JT.init_cache(cj, 2, cache_len, dtype=jdt))


def continuation(arch):
    """The reference's test_models_smoke.py continuation on the port:
    prefill's cache continues exactly like step-by-step decode."""
    _, ct = cfgs(arch)
    _, pt = params(arch)
    toks = port(tokens(ct, seed=7, b=1, s=8)[0])
    with torch.no_grad():
        logits_pf, cache_pf = TT.prefill(ct, pt, toks, 16)
        cache = TT.init_cache(ct, 1, 16, dtype=torch.float32)
        for i in range(8):
            logits_st, cache = TT.decode_step(ct, pt, cache,
                                              toks[:, i:i + 1], i)
        err = (logits_pf[:, -1] - logits_st[:, 0]).abs().max().item()
        assert err < 5e-4, err
        nxt = torch.argmax(logits_st[:, -1:], -1)
        l1, _ = TT.decode_step(ct, pt, cache_pf, nxt, 8)
        l2, _ = TT.decode_step(ct, pt, cache, nxt, 8)
    assert (l1 - l2).abs().max().item() < 5e-4


def soften(pj):
    """The JAX parameters with wq and wk × 0.1 (wherever an ``attn``
    subtree holds them): under the reference's init the smoke models'
    attention is near one-hot and amplifies one fp32 rounding into 1e-3
    parameter differences within a round, in the dense family as here
    (ROADMAP Queue 3), so trajectories are compared from softened
    attention, as ``tests/test_torch_train.py`` compares them."""
    def walk(t):
        if not isinstance(t, dict):
            return t
        out = {k: walk(v) for k, v in t.items()}
        if "wq" in out and "wk" in out:
            out["wq"], out["wk"] = out["wq"] * 0.1, out["wk"] * 0.1
        return out
    return walk(pj)


def engine_round(arch):
    """vrl_sgd + sgd on the flat engine, W = 2, one round of k = 2 steps
    from the same parameters (attention softened): each step's loss (with
    the router's aux term), the params and Δ after the sync, against the
    reference's ``make_train_step``."""
    cj, ct = cfgs(arch)
    pj = soften(params(arch)[0])
    pt = from_numpy(jax.tree.map(np.asarray, pj))
    jb = j_make(cj, JVRL(comm_period=K, learning_rate=LR, warmup=False,
                         update_backend="xla"), remat=False)
    tb = t_make(ct, TVRL(comm_period=K, learning_rate=LR, warmup=False),
                device="cpu")
    js = jb.engine.init(pj, W)
    ts = tb.engine.init(pt, W)
    data = j_stream(j_assign(W, W), S, cj.vocab_size, steps=K, batch=B,
                    alpha=0.05, seed=0)
    labels = np.roll(data, -1, axis=-1)
    js, lj = jax.jit(jb.round_step)(js, jnp.asarray(data),
                                    jnp.asarray(labels))
    ts, lt = tb.round_step(ts, port(data), port(labels))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    assert (ts.step, ts.last_sync) == (int(js.step), int(js.last_sync))
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.delta.numpy(), np.asarray(js.delta),
                               rtol=0, atol=1e-5 / (K * LR))


def stream_losses(recs):
    """(event, t, field, value) of every loss in a metrics stream."""
    out = []
    for r in recs:
        for f in ("loss", "local_loss", "avg_model_loss", "final_loss"):
            if f in r and r[f] is not None:
                out.append((r["event"], r.get("t"), f, r[f]))
    return out


def cli_start(arch, path, argv):
    """A step-0 checkpoint of the JAX parameters, attention softened, in
    the format both packages' CLIs resume (written through the port's
    ``save_flat_state``): the run ``argv`` asks for, before its first
    step."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.data import partition as partition_mod
    from repro_torch.launch import train as tlaunch
    args = tlaunch.parse_args(argv + ["--device", "cpu"])
    vrl = tlaunch.vrl_config(args)
    _, ct = cfgs(arch)
    eng = t_make(ct, vrl, remat=False, device="cpu").engine
    state = eng.init(from_numpy(jax.tree.map(np.asarray, soften(
        params(arch)[0]))), args.workers)
    meta = {"step": 0, "arch": args.arch, "workers": args.workers,
            "assignment": partition_mod.assignment_to_meta(
                partition_mod.contiguous_assignment(args.workers,
                                                    args.workers))}
    ckpt.save_flat_state(path, state, eng.spec, meta=meta,
                         compressors=comm_mod.pair_meta(eng.compressors),
                         moments=ckpt.moments_meta(vrl))
    return path


def cli_beside_reference(arch, tmp_path, argv):
    """Both CLIs resume ``cli_start``'s checkpoint with ``argv`` and
    ``--metrics``: the same events in the same order, every loss within
    1e-5.  Returns the port's run."""
    from repro.launch import train as j_launch
    from repro_torch.launch import train as tlaunch
    from repro_torch.obs.metrics import read_metrics
    start = cli_start(arch, str(tmp_path / "start"), argv)
    j_launch.main(argv + ["--resume", start, "--metrics",
                          str(tmp_path / "j.jsonl")])
    res = tlaunch.run(argv + ["--resume", start, "--device", "cpu",
                              "--metrics", str(tmp_path / "t.jsonl")])
    jr, tr = (read_metrics(str(tmp_path / f"{n}.jsonl")) for n in "jt")
    assert [r["event"] for r in tr] == [r["event"] for r in jr]
    lj, lt = stream_losses(jr), stream_losses(tr)
    assert [x[:3] for x in lt] == [x[:3] for x in lj] and len(lt) >= 4
    for a, b in zip(lt, lj):
        assert abs(a[3] - b[3]) <= 1e-5, (a, b)
    return res
