"""PyTorch port, the routed mixture of experts (``models.moe``, the moe
branches of ``models.transformer``, the configs phi3.5-moe-42b-a6.6b and
kimi-k2-1t-a32b) vs the JAX package, at small size on the CPU; and the
in-place scale of ``models.param``'s init.

Inputs are drawn with numpy (x ~ N(0, 1), router and experts ~ 0.1 and
0.05 · N(0, 1), as the reference's ``tests/test_moe.py``).  The expert
selection is discrete, so each check first asserts the ids and the keep
mask (which (token, expert) entries fit the capacity) equal to the
reference's, so that a flipped selection is reported as such, then holds
the values within a tolerance:
  - ``route``: weights and aux atol 1e-6 (fp32 softmax over E, summed in
    another order);
  - ``moe_mlp``: the output atol 1e-5 · max(1, max|y|) and aux atol 1e-6
    (the combine adds a token's k rows in another order than the
    reference's scatter, so not bitwise);
  - its gradients per leaf atol 1e-4 · max|g| (fp32 products of
    (E, C, d) buffers summed in other orders).
The whole smoke models are held as ``tests/torch_family_checks.py``
states.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_family_checks as FC  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="phi3.5-moe-42b-a6.6b", **kw):
    cj = dataclasses.replace(jreg.smoke_arch(arch), **kw)
    return cj, ModelConfig(**cj.__dict__)


def _moe_params(cfg, seed, shared=True):
    """numpy MoE parameters at the reference tests' scales."""
    rng = np.random.RandomState(seed)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.randn(d, e) * 0.1,
         "w_gate": rng.randn(e, d, ff) * 0.05,
         "w_up": rng.randn(e, d, ff) * 0.05,
         "w_down": rng.randn(e, ff, d) * 0.05}
    if shared and cfg.num_shared_experts:
        s = cfg.num_shared_experts * ff
        p.update(shared_w_gate=rng.randn(d, s) * 0.05,
                 shared_w_up=rng.randn(d, s) * 0.05,
                 shared_w_down=rng.randn(s, d) * 0.05)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(cfg, t, seed):
    return np.random.RandomState(seed).randn(t, cfg.d_model).astype(
        np.float32)


def _keep(ids: np.ndarray, cap: int) -> np.ndarray:
    """Which (token, expert) entries fit the capacity, in (T, k) order:
    the reference's stable sort and searchsorted, in numpy."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(srt, srt, side="left")
    keep = np.empty(flat.size, bool)
    keep[order] = pos < cap
    return keep.reshape(ids.shape)


def _tp(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


# ----------------------------------------------------------------- route
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [1, 64])
def test_route_matches_reference(arch, t):
    cj, ct = _cfgs(arch)
    router = _moe_params(cj, 0)["router"]
    x = _x(cj, t, 1)
    wj, ij, aj = JM.route(cj, jnp.asarray(router), jnp.asarray(x))
    wt, it, at = TM.route(ct, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.item(), float(aj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", list(jreg.list_archs()))
@pytest.mark.parametrize("t", [1, 7, 64, 512, 4096, 32768])
def test_capacity_matches_reference(arch, t):
    cj = jreg.get_arch(arch)
    if not cj.num_experts:
        cj = dataclasses.replace(cj, num_experts=16, experts_per_token=2)
    ct = ModelConfig(**cj.__dict__)
    assert TM.capacity(ct, t) == JM.capacity(cj, t)
    c = int(t * ct.experts_per_token * ct.capacity_factor / ct.num_experts)
    assert TM.capacity(ct, t) == max(8, 8 * math.ceil(c / 8))


# --------------------------------------------------------------- moe_mlp
# (capacity factor, shared experts): at T = 256 over the smoke variants' 4
# experts 1.0 drops some entries (the capacity is the mean load), 0.05
# drops most, 8.0 none
MLP_CASES = [(1.0, True), (1.0, False), (0.05, True), (8.0, False)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,shared", MLP_CASES)
def test_moe_mlp_matches_reference(arch, cf, shared):
    cj, ct = _cfgs(arch, capacity_factor=cf,
                   **({} if shared else {"num_shared_experts": 0}))
    p = _moe_params(cj, 2)
    x = _x(cj, 256, 3)
    _, ids, _ = JM.route(cj, jnp.asarray(p["router"]), jnp.asarray(x))
    _, tids, _ = TM.route(ct, torch.from_numpy(p["router"]),
                          torch.from_numpy(x))
    cap = JM.capacity(cj, 256)
    keep = _keep(np.asarray(ids), cap)
    np.testing.assert_array_equal(_keep(tids.numpy(), cap), keep)
    if cf == 8.0:
        assert keep.all()
    else:
        assert not keep.all()
    yj, aj = JM.moe_mlp(cj, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    yt, at = TM.moe_mlp(ct, _tp(p), torch.from_numpy(x))
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(yj).max()))
    np.testing.assert_allclose(at.item(), float(aj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.0, 0.05])
def test_moe_mlp_gradients_match_reference(arch, cf):
    """d/d(x, every weight) of Σ y · r + 0.3 · aux, against jax.grad."""
    cj, ct = _cfgs(arch, capacity_factor=cf)
    p = _moe_params(cj, 4)
    x = _x(cj, 128, 5)
    r = np.random.RandomState(6).randn(128, cj.d_model).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_mlp(cj, p, x)
        return jnp.sum(y * r) + 0.3 * aux
    gpj, gxj = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    pt = {k: v.requires_grad_() for k, v in _tp(p).items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y, aux = TM.moe_mlp(ct, pt, xt)
    loss = torch.sum(y * torch.from_numpy(r)) + 0.3 * aux
    names = sorted(pt)
    grads = torch.autograd.grad(loss, [pt[k] for k in names] + [xt])
    for name, g, want in zip(names + ["x"], grads,
                             [gpj[k] for k in names] + [gxj]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_moe_mlp_forward_and_backward_repeat_bitwise():
    """The permutation dispatch: two forward/backward passes are bitwise
    equal (on the card this is what the scatter-free token side buys;
    chip_smoke.py (ar) holds two card runs of a training round)."""
    _, ct = _cfgs(capacity_factor=1.0)
    p = _moe_params(ct, 7)
    x = _x(ct, 200, 8)
    outs = []
    for _ in range(2):
        pt = {k: v.requires_grad_() for k, v in _tp(p).items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        y, aux = TM.moe_mlp(ct, pt, xt)
        g = torch.autograd.grad((y ** 2).sum() + aux, [xt] + list(
            pt.values()))
        outs.append((y.detach(), aux.detach(), g))
    (y0, a0, g0), (y1, a1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------------- the reference's tests/test_moe.py
def test_router_weights_normalized():
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, cfg.d_model), generator=gen)
    router = torch.randn((cfg.d_model, cfg.num_experts), generator=gen) * 0.1
    w, ids, aux = TM.route(cfg, router, x)
    torch.testing.assert_close(w.sum(-1), torch.ones(64), rtol=1e-5,
                               atol=0)
    assert ids.shape == (64, cfg.experts_per_token)
    assert bool((ids < cfg.num_experts).all())


def test_moe_capacity_drops_only_overflow():
    """With capacity_factor high enough nothing is dropped: the MoE output
    must equal a dense per-token expert evaluation."""
    _, cfg = _cfgs(capacity_factor=8.0, num_shared_experts=0)
    p = _tp(_moe_params(cfg, 0, shared=False))
    x = torch.from_numpy(_x(cfg, 32, 4))
    y, aux = TM.moe_mlp(cfg, p, x)
    # dense reference: evaluate every expert on every token, combine top-k
    w, ids, _ = TM.route(cfg, p["router"], x)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", x, p["w_gate"]))
    h = h * torch.einsum("td,edf->tef", x, p["w_up"])
    all_out = torch.einsum("tef,efd->ted", h, p["w_down"])
    ref = torch.zeros_like(x)
    for j in range(cfg.experts_per_token):
        ref = ref + w[:, j:j + 1] * all_out[torch.arange(32), ids[:, j]]
    assert (y - ref).abs().max().item() < 1e-4


def test_moe_capacity_one_drops_tokens():
    _, cfg = _cfgs(capacity_factor=0.01, num_shared_experts=0)
    p = _tp(_moe_params(cfg, 1, shared=False))
    x = torch.from_numpy(_x(cfg, 256, 4))
    y, _ = TM.moe_mlp(cfg, p, x)
    assert bool(torch.isfinite(y).all())
    # some tokens must have been dropped to zero contribution
    norms = torch.linalg.norm(y, dim=-1)
    assert (norms < 1e-9).float().mean().item() > 0.1


def test_aux_loss_uniform_router_is_one():
    """Switch LB loss == 1.0 for a perfectly uniform router."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((512, cfg.d_model), generator=gen)
    # zero logits -> uniform probs; top-1 ties broken deterministically, so
    # f_e collapses — perturb tiny bit for realistic tie-breaking
    router = 1e-6 * torch.randn((cfg.d_model, cfg.num_experts),
                                generator=gen)
    _, _, aux = TM.route(cfg, router, x)
    assert 0.5 < aux.item() < 2.5


# ----------------------------------------------- the smoke architectures
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_counts_match_reference(arch):
    FC.config_matches(arch)
    # the tree holds the reference's count plus the final norm (d)
    FC.materialised_counts(arch, treg.get_arch(arch).d_model)
    cfg = treg.get_arch(arch)
    assert cfg.active_param_count() < cfg.param_count()


def test_registry_counts_phi_and_kimi():
    phi, kimi = (treg.get_arch(a) for a in ARCHS)
    assert (phi.param_count(), phi.active_param_count()) == (
        41_872_523_264, 6_640_369_664)
    assert (kimi.param_count(), kimi.active_param_count()) == (
        1_043_853_432_832, 33_747_589_120)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_aux_match_reference(arch):
    FC.logits_and_aux(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    FC.loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise(arch):
    FC.remat_bitwise(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    FC.prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    FC.init_cache_matches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continuation(arch):
    FC.continuation(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_round_matches_reference(arch):
    FC.engine_round(arch)


# ------------------------------------------------------------- the CLIs
CLI = ["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--workers", "2",
       "--batch", "2", "--seq", "32", "--steps", "6", "--k", "2", "--lr",
       "0.05", "--log-every", "1", "--backend", "xla"]


def test_launch_train_beside_reference_cli(tmp_path, capsys):
    """``launch.train --arch phi3.5-moe-42b-a6.6b --smoke`` and the
    reference's CLI from one step-0 checkpoint: the same metrics events,
    every loss within 1e-5 (``torch_family_checks.cli_beside_reference``)."""
    res = FC.cli_beside_reference("phi3.5-moe-42b-a6.6b", tmp_path, CLI)
    assert len(res.losses) == 6 and np.all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "phi3.5-moe-42b-a6.6b [moe]" in out and "active=6.64B" in out


def test_launch_serve_runs_moe_on_cpu(capsys):
    for arch in ARCHS:
        res = tserve.run(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "12", "--gen",
                          "4"])
        assert tuple(res.out.shape) == (2, 16)
        assert torch.equal(res.out[:, :12], res.prompt)
        out = capsys.readouterr().out
        assert "[moe]" in out and "active=" in out


# ------------------------------------------- the init's in-place scale
def _materialize_two_copies(defs, seed):
    """``materialize`` as it drew before its scale went in place: the
    draw, then ``x * scale`` as a second fp32 copy."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for path, d in tm.leaves_with_path(defs):
        if d.init in ("zeros", "ones"):
            out.append((path, getattr(torch, d.init)(d.shape)))
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32)
        out.append((path, x * scale))
    return out


@pytest.mark.parametrize("arch", list(treg.list_archs()))
def test_in_place_init_is_bitwise_the_two_copy_init(arch):
    cfg = treg.smoke_arch(arch)
    got = tm.leaves_with_path(TT.init_params(cfg, seed=3))
    want = _materialize_two_copies(TT.model_defs(cfg), 3)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), path
    bf = tm.leaves(tparam.materialize(TT.model_defs(cfg), 3, torch.bfloat16))
    assert all(torch.equal(a, b.to(torch.bfloat16))
               for a, (_, b) in zip(bf, want))
