"""PyTorch port, the Hymba-style hybrid block (``models.hybrid``, the
hybrid branches of ``models.transformer``, the config hymba-1.5b) and the
serving example ``repro_torch.examples.serve_decode`` vs the JAX package,
at small size on the CPU.

The block runs the port's attention and SSM modules in parallel on one
input and fuses their normalised outputs; its decode cache nests the
attention's KV (a ring buffer of the window when there is one) and the
SSM's state and conv window.  Inputs are drawn with numpy; the JAX
parameters are carried across with ``from_numpy``.  Tolerances: the
block's output and the attention cache atol 1e-5 · max(1, max|y|) (fp32,
summed in other orders; the fused output is of unit RMS), the SSM state
(it reaches ~1e1) atol 1e-4 · max(1, max|leaf|), as
``tests/test_torch_ssm.py``; the whole smoke model as
``tests/torch_family_checks.py`` states.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_family_checks as FC  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

ARCH = "hymba-1.5b"
ARCHS = [ARCH]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    cj = dataclasses.replace(jreg.smoke_arch(ARCH), **kw)
    return cj, ModelConfig(**cj.__dict__)


def _block_params(cj, seed=0):
    """One hybrid block's JAX parameters (fuse_beta drawn away from its
    ones, so that the fuse's weights are held too) and their port copy."""
    pj = jparam.materialize(JH.hybrid_defs(cj), jax.random.PRNGKey(seed))
    pj["fuse_beta"] = jnp.asarray([0.7, 1.3], jnp.float32)
    return pj, from_numpy(jax.tree.map(np.asarray, pj))


def _x(cj, b, s, seed=1):
    return np.random.RandomState(seed).randn(b, s, cj.d_model).astype(
        np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_hybrid_defs_match_reference():
    cj, ct = _cfgs()
    dj = jparam.abstract(JH.hybrid_defs(cj))
    dt = tparam.abstract(TH.hybrid_defs(ct))
    assert [(p, tuple(x.shape)) for p, x in tm.leaves_with_path(dt)] == [
        (p, tuple(x.shape)) for p, x in tm.leaves_with_path(dj)]
    beta = TH.hybrid_defs(ct)["fuse_beta"]
    assert (beta.shape, beta.init) == ((2,), "ones")
    p = tparam.materialize(TH.hybrid_defs(ct), 0)
    assert torch.equal(p["fuse_beta"], torch.ones(2))


@pytest.mark.parametrize("window", [None, 8, 64])
def test_hybrid_forward_matches_reference(window):
    """The window given, or the config's (64 at the smoke size: wider
    than the sequence) when None."""
    cj, ct = _cfgs()
    pj, pt = _block_params(cj)
    x, pos = _x(cj, 2, 40), _positions(2, 40)
    want = JH.hybrid_forward(cj, pj, jnp.asarray(x), jnp.asarray(pos),
                             window=window)
    with torch.no_grad():
        got = TH.hybrid_forward(ct, pt, torch.from_numpy(x),
                                torch.from_numpy(pos).long(), window=window)
    _close(got, want)


def test_fuse_matches_reference():
    cj, ct = _cfgs()
    pj, pt = _block_params(cj)
    ya, ys = _x(cj, 2, 5, 2) * 3.0, _x(cj, 2, 5, 3) * 0.2
    want = JH._fuse(pj, jnp.asarray(ya), jnp.asarray(ys), cj.norm_eps)
    _close(TH._fuse(pt, torch.from_numpy(ya), torch.from_numpy(ys),
                    ct.norm_eps), want)


def _assert_cache(got, want):
    """The nested cache leaf by leaf: paths, shapes, dtypes; KV atol 1e-5 ·
    max(1, max|leaf|), the SSM leaves 1e-4 · max(1, max|leaf|)."""
    want = jax.tree.map(np.asarray, want)
    gl, wl = tm.leaves_with_path(got), tm.leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl] == [
        "attn/k", "attn/v", "ssm/conv", "ssm/state"]
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        w32 = w.astype(np.float32)
        tol = 1e-5 if path.startswith("attn") else 1e-4
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=0,
                                   atol=tol * max(1.0, np.abs(w32).max()),
                                   err_msg=path)


# (window, cache_len, sequence): the config's window 64 past the sequence,
# a window of 8 the sequence wraps (ring buffer), no window (cache_len
# slots), and a sequence past the smoke chunk (32) and the window
CACHE_CASES = [(None, 48, 20), (8, 48, 20), (0, 48, 20), (None, 96, 70),
               (8, 16, 3)]


@pytest.mark.parametrize("window,cache_len,s", CACHE_CASES)
def test_prefill_cache_and_decode_match_reference(window, cache_len, s):
    """hybrid_forward(return_cache=True): the output and the nested cache
    (KV over min(cache_len, w) slots, or a window ring buffer); then four
    hybrid_decode_steps from it.  ``window`` 0 runs the config without a
    window."""
    kw = {"attn_window": None} if window == 0 else {}
    w = None if window == 0 else window
    cj, ct = _cfgs(**kw)
    pj, pt = _block_params(cj)
    x, pos = _x(cj, 2, s + 4), _positions(2, s)
    yj, cache_j = JH.hybrid_forward(cj, pj, jnp.asarray(x[:, :s]),
                                    jnp.asarray(pos), window=w,
                                    return_cache=True, cache_len=cache_len)
    with torch.no_grad():
        yt, cache_t = TH.hybrid_forward(
            ct, pt, torch.from_numpy(x[:, :s]), torch.from_numpy(pos).long(),
            window=w, return_cache=True, cache_len=cache_len)
    _close(yt, yj)
    _assert_cache(cache_t, cache_j)
    for p in range(s, s + 4):
        yj, cache_j = JH.hybrid_decode_step(cj, pj, jnp.asarray(
            x[:, p:p + 1]), cache_j, p, window=w)
        with torch.no_grad():
            yt, cache_t = TH.hybrid_decode_step(ct, pt, torch.from_numpy(
                x[:, p:p + 1]), cache_t, p, window=w)
        _close(yt, yj)
    _assert_cache(cache_t, cache_j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_hybrid_cache_matches_reference(dtype):
    cj, ct = _cfgs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _assert_cache(TH.init_hybrid_cache(ct, 3, 24, dtype),
                  JH.init_hybrid_cache(cj, 3, 24, jdt))


# ----------------------------------------------- the smoke architecture
def test_config_and_counts_match_reference():
    FC.config_matches(ARCH)
    # the reference's formula counts the B/C projections per head and
    # leaves out the final norm, both output norms and fuse_beta: the
    # tree holds 80,271,040 fewer than it counts
    FC.materialised_counts(ARCH, -80_271_040)
    cfg = treg.get_arch(ARCH)
    assert cfg.param_count() == cfg.active_param_count() == 1_669_940_800
    assert cfg.subquadratic and not cfg.is_attention_free


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_aux_match_reference(arch):
    FC.logits_and_aux(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    FC.loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise(arch):
    FC.remat_bitwise(arch)


@pytest.mark.parametrize("s,cache_len", [(10, 16), (70, 96)])
def test_prefill_and_decode_match_reference(s, cache_len):
    """Past the smoke window (64) and chunk (32) at 70: the ring buffer
    wraps and the SSM state crosses chunk boundaries."""
    FC.prefill_and_decode(ARCH, s=s, cache_len=cache_len)


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
CLI = ["--arch", ARCH, "--smoke", "--workers", "2", "--batch", "2",
       "--seq", "40", "--steps", "6", "--k", "2", "--lr", "0.05",
       "--log-every", "1", "--backend", "xla"]


def test_launch_train_beside_reference_cli(tmp_path, capsys):
    """``launch.train --arch hymba-1.5b --smoke`` (seq 40: past the smoke
    chunk) and the reference's CLI from one step-0 checkpoint: the same
    metrics events, every loss within 1e-5."""
    res = FC.cli_beside_reference(ARCH, tmp_path, CLI)
    assert len(res.losses) == 6 and np.all(np.isfinite(res.losses))
    assert "hymba-1.5b [hybrid]" in capsys.readouterr().out


def test_launch_serve_runs_hymba_on_cpu(capsys):
    """A prompt past the smoke window (64): the ring buffer wraps."""
    res = tserve.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "70", "--gen", "6"])
    assert tuple(res.out.shape) == (2, 76)
    assert torch.equal(res.out[:, :70], res.prompt)
    cache = res.engine.prefill(res.prompt)[1]
    assert tuple(cache["attn"]["k"].shape[:3]) == (2, 2, 64)
    assert "ms per token" in capsys.readouterr().out


def test_serve_decode_example_runs_on_cpu(capsys):
    out = serve_decode.main(["--device", "cpu"])
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "granite-3-2b": (4, 48), "mamba2-370m": (4, 48),
        "hymba-1.5b": (4, 48), "windowed": (2, 80)}
    text = capsys.readouterr().out
    assert "[hybrid]" in text and "ring buffer 32" in text
