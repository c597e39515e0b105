"""PyTorch port, the serving path (``models.attention`` decode and KV
cache, ``models.transformer`` prefill / decode_step / init_cache,
``serve.Engine``, ``launch.serve``) vs the JAX package, at smoke size.

The JAX parameters are carried across with ``from_numpy``; the same numpy
tokens go through both packages.  Tolerances: logits atol 1e-4, the
port's model tolerance (tests/test_torch_model.py: two fp32
implementations sum in other orders); the KV cache (roped k and v of each
layer, values up to ~20) atol 1e-4 · max(1, max|k|).  Greedy tokens are
held to the reference's only where its top-2 margin exceeds twice the
logits tolerance: below that the two packages may pick either.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import make_prefill, make_serve_step  # noqa: E402

ARCHS = ("qwen2-0.5b", "granite-3-2b")
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j, cfg_t = jreg.smoke_arch(arch), treg.smoke_arch(arch)
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(cfg, seed, b=2, s=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _assert_logits(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


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


def test_granite_config_matches_reference():
    name = "granite-3-2b"
    assert jreg.get_arch(name).__dict__ == treg.get_arch(name).__dict__
    assert jreg.smoke_arch(name).__dict__ == treg.smoke_arch(name).__dict__
    assert (jreg.get_arch(name).param_count()
            == treg.get_arch(name).param_count())


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits_and_cache_match_reference(model, window, last_only):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(cfg_t, 1)
    lj, cj = JT.prefill(cfg_j, pj, jnp.asarray(toks), 16, window=window,
                        last_only=last_only)
    with torch.no_grad():
        lt, ct = TT.prefill(cfg_t, pt, torch.from_numpy(toks).long(), 16,
                            window=window, last_only=last_only)
    _assert_logits(lt, lj)
    _assert_cache(ct, cj)


def test_prefill_matches_forward(model):
    """prefill's logits are the training forward's."""
    _, cfg_t, _, pt = model
    toks = torch.from_numpy(_tokens(cfg_t, 2)).long()
    with torch.no_grad():
        lp, _ = TT.prefill(cfg_t, pt, toks, 16)
        lf = TT.forward(cfg_t, pt, toks)
    np.testing.assert_allclose(lp.numpy(), lf.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [None, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(model, window, dtype):
    cfg_j, cfg_t, _, _ = model
    cj = JT.init_cache(cfg_j, 3, 16, dtype=getattr(jnp, dtype),
                       window=window)
    ct = TT.init_cache(cfg_t, 3, 16, dtype=getattr(torch, dtype),
                       window=window)
    _assert_cache(ct, cj)
    assert all(not t.any() for t in ct.values())


def test_init_cache_defaults_to_bf16(model):
    cfg_j, cfg_t, _, _ = model
    assert TT.init_cache(cfg_t, 1, 4)["k"].dtype == torch.bfloat16
    assert JT.init_cache(cfg_j, 1, 4)["k"].dtype == jnp.bfloat16


# ------------------------------------------------------------------ decode
def _teacher_forced(cfg_j, cfg_t, pj, pt, toks, cache_j, cache_t, start,
                    window=None):
    """Decode toks[:, i] at position start + i on both sides; compare the
    logits and the caches at every step."""
    jstep = jax.jit(lambda c, t, p: JT.decode_step(cfg_j, pj, c, t, p,
                                                   window=window))
    for i in range(toks.shape[1]):
        pos = start + i
        lj, cache_j = jstep(cache_j, jnp.asarray(toks[:, i:i + 1]), pos)
        with torch.no_grad():
            lt, cache_t = TT.decode_step(
                cfg_t, pt, cache_t, torch.from_numpy(toks[:, i:i + 1]).long(),
                pos, window=window)
        _assert_logits(lt, lj)
        _assert_cache(cache_t, cache_j)
    return cache_j, cache_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_empty_cache_matches_reference(model, dtype):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(cfg_t, 3, s=6)
    cj = JT.init_cache(cfg_j, 2, 8, dtype=getattr(jnp, dtype))
    ct = TT.init_cache(cfg_t, 2, 8, dtype=getattr(torch, dtype))
    _teacher_forced(cfg_j, cfg_t, pj, pt, toks, cj, ct, 0)


def test_decode_after_prefill_matches_reference(model):
    """The reference's greedy tokens, fed to both after a prefill."""
    cfg_j, cfg_t, pj, pt = model
    prompt = _tokens(cfg_t, 4)
    out = np.array(JEngine(cfg_j, pj, max_len=16).generate(
        jnp.asarray(prompt), 8))
    _, cj = JT.prefill(cfg_j, pj, jnp.asarray(prompt), 16)
    with torch.no_grad():
        _, ct = TT.prefill(cfg_t, pt, torch.from_numpy(prompt).long(), 16)
    _teacher_forced(cfg_j, cfg_t, pj, pt, out[:, 8:], cj, ct, 8)


@pytest.mark.parametrize("window", [4, 5])
def test_window_ring_buffer_past_the_window(model, window):
    """A sliding window of 4 (5) over a 6-token prefill and 10 decode
    steps: the ring buffer wraps more than once; logits and the ring's
    slots match the reference's at every step."""
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(cfg_t, 5, s=16)
    _, cj = JT.prefill(cfg_j, pj, jnp.asarray(toks[:, :6]), 32,
                       window=window)
    with torch.no_grad():
        _, ct = TT.prefill(cfg_t, pt, torch.from_numpy(toks[:, :6]).long(),
                           32, window=window)
    assert ct["k"].shape[2] == window
    _assert_cache(ct, cj)
    _teacher_forced(cfg_j, cfg_t, pj, pt, toks[:, 6:], cj, ct, 6,
                    window=window)


@pytest.mark.parametrize("pos", [7, 8, 11])
def test_decode_clamps_past_the_cache(model, pos):
    """At pos >= cache_len the reference's dynamic_update_slice clamps the
    write to the last slot (XLA's clamp): the port writes there too."""
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(cfg_t, 6, s=8)
    _, cj = JT.prefill(cfg_j, pj, jnp.asarray(toks[:, :7]), 8)
    with torch.no_grad():
        _, ct = TT.prefill(cfg_t, pt, torch.from_numpy(toks[:, :7]).long(),
                           8)
    cj2, ct2 = _teacher_forced(cfg_j, cfg_t, pj, pt, toks[:, 7:], cj, ct,
                               pos)
    assert not torch.equal(ct2["k"][:, :, 7], ct["k"][:, :, 7])
    assert torch.equal(ct2["k"][:, :, :7], ct["k"][:, :, :7])


def test_decode_attend_slot_and_clamp():
    """One layer: the slot written is pos (full), pos % W (window, floor
    mod), clamped into [0, cache_len) for full attention."""
    cfg = treg.smoke_arch("qwen2-0.5b")
    p = tm.tree_map(lambda t: t[0], TT.init_params(cfg, 0)["layers"]["attn"])
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    cache = TA.init_kv_cache(cfg, 1, 6, torch.float32)
    for pos, window, slot in ((2, None, 2), (9, None, 5), (-3, None, 0),
                              (9, 6, 3), (-1, 6, 5)):
        _, new = TA.decode_attend(cfg, p, x, cache, pos, window=window)
        written = [i for i in range(6) if new["k"][0, i].any()]
        assert written == [slot], (pos, window, written)


def test_prefill_then_decode_continuation(model):
    """The reference's test_models_smoke.py:71 on the port: prefill's cache
    continues exactly like step-by-step decode."""
    _, cfg, _, params = model
    toks = torch.from_numpy(_tokens(cfg, 7, b=1, s=8)).long()
    with torch.no_grad():
        logits_pf, cache_pf = TT.prefill(cfg, params, toks, 16)
        cache = TT.init_cache(cfg, 1, 16, dtype=torch.float32)
        for i in range(8):
            logits_st, cache = TT.decode_step(cfg, params, cache,
                                              toks[:, i:i + 1], i)
        err = (logits_pf[:, -1] - logits_st[:, 0]).abs().max().item()
        assert err < 5e-4, err
        nxt = torch.argmax(logits_st[:, -1:], -1)
        l1, _ = TT.decode_step(cfg, params, cache_pf, nxt, 8)
        l2, _ = TT.decode_step(cfg, params, cache, nxt, 8)
    assert (l1 - l2).abs().max().item() < 5e-4


def test_serve_step_and_prefill_factories(model):
    _, cfg, _, params = model
    toks = torch.from_numpy(_tokens(cfg, 8)).long()
    with torch.no_grad():
        logits, cache = make_prefill(cfg, 12, last_only=True)(params, toks)
        assert logits.shape == (2, 1, cfg.vocab_size)
        nxt = torch.argmax(logits, -1)
        l1, c1 = make_serve_step(cfg)(params, cache, nxt, 8)
        l2, c2 = TT.decode_step(cfg, params, cache, nxt, 8)
    assert torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])


# ------------------------------------------------------------------ engine
def _margins(cfg_j, pj, out, s, max_len):
    """The reference's top-2 margin at each generated position, from its
    own prefill and teacher-forced decode of its tokens."""
    logits, cache = JT.prefill(cfg_j, pj, jnp.asarray(out[:, :s]), max_len,
                               last_only=True)
    margins = []
    for i in range(out.shape[1] - s):
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if s + i + 1 < out.shape[1]:
            tok = jnp.asarray(out[:, s + i:s + i + 1])
            logits, cache = JT.decode_step(cfg_j, pj, cache, tok, s + i)
    return np.stack(margins, axis=1)            # (B, steps)


@pytest.mark.parametrize("window", [None, 8])
def test_engine_greedy_matches_reference(model, window):
    cfg_j, cfg_t, pj, pt = model
    prompt = _tokens(cfg_t, 9, b=3, s=8)
    want = np.asarray(JEngine(cfg_j, pj, max_len=20, window=window)
                      .generate(jnp.asarray(prompt), 12))
    got = TEngine(cfg_t, pt, max_len=20, window=window).generate(
        torch.from_numpy(prompt).long(), 12).numpy()
    assert got.shape == want.shape == (3, 20)
    np.testing.assert_array_equal(got[:, :8], prompt)
    if window is None:
        margins = _margins(cfg_j, pj, want, 8, 20)
        compared = 0
        for row in range(3):
            for i in range(12):
                if margins[row, i] <= 2 * LOGIT_TOL:
                    break               # either pick is right; they part
                assert got[row, 8 + i] == want[row, 8 + i], (row, i)
                compared += 1
        assert compared >= 12
    else:
        np.testing.assert_array_equal(got, want)


def test_engine_takes_numpy_and_first_maximum():
    """Ties go to the first maximum, as jnp.argmax's."""
    cfg = treg.smoke_arch("qwen2-0.5b")
    params = TT.init_params(cfg, 0)
    params["embed"].zero_()             # every logit 0: argmax is token 0
    out = TEngine(cfg, params, max_len=8).generate(
        np.zeros((2, 3), dtype=np.int64), 4)
    assert out.shape == (2, 7) and not out[:, 3:].any()


def test_engine_temperature_sampling_is_deterministic_per_generator(model):
    _, cfg, _, params = model
    eng = TEngine(cfg, params, max_len=24)
    prompt = torch.from_numpy(_tokens(cfg, 10)).long()

    def draw(seed):
        return eng.generate(prompt, 16, temperature=0.8,
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    # the first token after the prompt is greedy, as in the reference
    greedy = eng.generate(prompt, 1)
    assert torch.equal(a[:, :9], greedy) and torch.equal(c[:, :9], greedy)
    with pytest.raises(ValueError):
        eng.generate(prompt, 4, temperature=0.5)


def test_engine_records_timings(model):
    _, cfg, _, params = model
    timings = {}
    TEngine(cfg, params, max_len=16).generate(
        torch.from_numpy(_tokens(cfg, 11)).long(), 5, timings=timings)
    assert timings["prefill_ms"] > 0 and len(timings["decode_ms"]) == 4


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_on_cpu(arch, capsys):
    res = tserve.run(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "6"])
    assert tuple(res.out.shape) == (2, 14)
    assert torch.equal(res.out[:, :8], res.prompt)
    assert int(res.out.min()) >= 0
    assert int(res.out.max()) < res.cfg.vocab_size
    assert res.peak_bytes is None and len(res.decode_ms) == 5
    text = capsys.readouterr().out
    assert "prefill" in text and "ms per token" in text and "tok/s" in text


def test_serve_cli_temperature_and_default_arch(capsys):
    assert tserve.parse_args([]).arch == "granite-3-2b"
    assert tserve.parse_args([]).device == "cuda"
    assert tserve.main(["--smoke", "--device", "cpu", "--batch", "1",
                        "--prompt-len", "4", "--gen", "3",
                        "--temperature", "0.9", "--seed", "3"]) == 0
    assert "granite-3-2b" in capsys.readouterr().out


def test_serve_cli_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: --device cuda runs")
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--smoke", "--device", "cuda"])
    assert exc.value.code not in (0, None)


def _prefill_decode_gap(prefill, decode, toks, s):
    """max over the decode steps after ``s`` prompt tokens of |decode −
    prefill of the same prefix| / max|prefill logit|."""
    worst = 0.0
    _, cache = prefill(toks[:, :s])
    for pos in range(s, toks.shape[1]):
        dl, cache = decode(cache, toks[:, pos:pos + 1], pos)
        pl, _ = prefill(toks[:, :pos + 1])
        dl, pl = np.asarray(dl, np.float32), np.asarray(pl, np.float32)
        worst = max(worst, float(np.abs(dl - pl[:, -1:]).max()
                                 / np.abs(pl[:, -1]).max()))
    return worst


def test_depth_parts_prefill_from_decode_under_the_init():
    """Why chip_smoke holds the full-depth prefill/decode check with wq, wk
    × 0.1: under the reference's init (fan-in taken as the head count) the
    attention scores grow with depth until the softmax is near one-hot, and
    two summation orders of the same logits part.  At 24 layers (d 128) the
    JAX package's own prefill and decode differ by more than 1e-2 ·
    max|logit|; with wq, wk × 0.1 they, and the port's, agree within 5e-4.
    (The port's CPU prefill and decode may agree bitwise at any scale: one
    matmul kernel can serve both shapes; on the card they differ.)"""
    cfg_j = jreg.smoke_arch("qwen2-0.5b", num_layers=24)
    cfg_t = treg.smoke_arch("qwen2-0.5b", num_layers=24)
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    toks = _tokens(cfg_t, 12, b=2, s=40)
    gaps = {}
    for scale in (1.0, 0.1):
        pjs = dict(pj, layers=dict(pj["layers"], attn=dict(
            pj["layers"]["attn"], wq=pj["layers"]["attn"]["wq"] * scale,
            wk=pj["layers"]["attn"]["wk"] * scale)))
        pts = from_numpy(jax.tree.map(np.asarray, pjs))
        jdec = jax.jit(lambda c, t, p, pjs=pjs: JT.decode_step(
            cfg_j, pjs, c, t, p))
        gaps["jax", scale] = _prefill_decode_gap(
            lambda t, pjs=pjs: JT.prefill(cfg_j, pjs, jnp.asarray(t), 48,
                                          last_only=True),
            lambda c, t, p: jdec(c, jnp.asarray(t), p), toks, 32)
        with torch.no_grad():
            gaps["port", scale] = _prefill_decode_gap(
                lambda t, pts=pts: TT.prefill(cfg_t, pts,
                                              torch.from_numpy(t).long(),
                                              48, last_only=True),
                lambda c, t, p, pts=pts: TT.decode_step(
                    cfg_t, pts, c, torch.from_numpy(t).long(), p),
                toks, 32)
    assert gaps["jax", 1.0] > 1e-2, gaps
    assert gaps["jax", 0.1] < 5e-4 and gaps["port", 0.1] < 5e-4, gaps
