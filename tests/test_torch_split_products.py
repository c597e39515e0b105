"""PyTorch port: the numerics of the split products that run
``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` on the tensor cores.

The kernels take each fp32 product on the tensor cores as three TF32
products, x = hi + lo with hi = TF32(x) and lo = TF32(x − hi), a·b as
lo_a·hi_b + hi_a·lo_b + hi_a·hi_b accumulated in fp32
(``csrc/split_mma.cuh``).  No card here, so this file emulates that
arithmetic in plain PyTorch — TF32 as round to nearest, ties away, to 10
explicit mantissa bits (``cvt.rna.tf32.f32``); each product of TF32 values
is exact in fp32 and the sums are fp32 — and runs the kernels' algorithms
with it against the port's plain versions under the tolerances that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels to:

- one TF32 product per pair fails them (so those checks would catch a
  kernel without the compensation), and the split passes them with room;
- a bf16 value is exact in TF32: its remainder is 0, so bf16 operands
  need one product (bf16 q and k in attention, bf16 B and C in C·Bᵀ);
- in bf16 attention p is not exact: p rounded once to bf16 (one bf16
  product for p·v) fails the bf16 tolerance, and p as a bf16 hi and lo
  (two products, as the kernel takes them) passes it.

Inputs are numpy draws from fixed seeds, as in the kernels' card tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402

F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped
    13 bits' weight to the magnitude, then clear them."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: both operands rounded, fp32 sums."""
    return tf32(a) @ tf32(b)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' three-product split, the small terms first."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


# ------------------------------------------------------------ attention
def attention(q, k, v, mm):
    """Causal attention over (BH, S, D) fp32 with every product through
    ``mm``: the scale after q·kᵀ, −1e30 where masked, one softmax, p·v,
    the division by max(l, 1e-30)."""
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])
    s = torch.where(pos[None, :] <= pos[:, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm(p, v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def attention_ratio(got, want):
    """err / bound under the fp32 tolerance rtol 2e-4, atol 2e-5."""
    return (got - want).abs() / (2e-5 + 2e-4 * want.abs())


def _qkv(seed, bh=4, s=512, d=64):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
            for _ in range(3)]


def test_one_tf32_product_fails_the_attention_tolerance():
    """(BH, S, D) = (4, 512, 64), causal: one TF32 product per pair puts
    thousands of outputs past rtol 2e-4 / atol 2e-5, so the fp32 checks
    would catch a kernel that took the products uncompensated."""
    q, k, v = _qkv(0)
    ratio = attention_ratio(attention(q, k, v, mm_tf32),
                            tfa.flash_attention_ref(q, k, v))
    assert int((ratio > 1).sum()) > 1000
    assert ratio.max().item() > 5.0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_products_pass_the_attention_tolerance(seed):
    """The same shape through the three-product split: every output
    within a tenth of the fp32 tolerance."""
    q, k, v = _qkv(seed)
    ratio = attention_ratio(attention(q, k, v, mm_split),
                            tfa.flash_attention_ref(q, k, v))
    assert ratio.max().item() <= 0.1


@pytest.mark.parametrize("seed", [2, 4])
def test_split_products_pass_at_large_scores(seed):
    """q · 10: scores of magnitude ~80, a sharply peaked softmax (the card
    test's large-score case).  There every fp32 evaluation sits nearer the
    tolerance: p moves by |s|·ulp, and the plain version itself lies ~0.3
    of the bound from an fp64 evaluation.  The split stays within the
    tolerance of the plain version and within half of it of fp64, where
    one TF32 product misses by a factor of more than ten."""
    q, k, v = _qkv(seed, s=256)
    q = q * 10
    want = tfa.flash_attention_ref(q, k, v)
    exact = attention(q.double(), k.double(), v.double(), torch.matmul)
    got = attention(q, k, v, mm_split)
    assert attention_ratio(got, want).max().item() < 1.0
    assert attention_ratio(got, exact.float()).max().item() <= 0.5
    assert attention_ratio(attention(q, k, v, mm_tf32),
                           want).max().item() > 10.0


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


def bf16_attention(q, k, v, pv_products):
    """Causal bf16 attention as the kernel computes it: q·kᵀ of bf16
    values exact in fp32, the fp32 softmax, p·v against the exact bf16 v
    with p rounded to bf16 once (one product) or as a bf16 hi and lo (two
    products), the fp32 sum of p, the output rounded to bf16."""
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])
    s = torch.where(pos[None, :] <= pos[:, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = bf16(p)
    acc = hi @ v if pv_products == 1 else bf16(p - hi) @ v + hi @ v
    return (acc / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def bf16_attention_ratio(got, want):
    """err / bound under chip_smoke's bf16 tolerance: one bf16 ulp of the
    output beyond rtol 2e-4, atol 2e-5."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e.clamp_min(-125) - 8)
    return (g - w).abs() / (2e-5 + 2e-4 * w.abs() + ulp)


@pytest.mark.parametrize("pv_products", [1, 2])
@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_bf16_pv_needs_two_products(pv_products, scale):
    """(BH, S, D) = (4, 512, 64) bf16, causal, q at unit scale and × 10:
    with p rounded once to bf16 thousands of outputs fall past the bf16
    tolerance; with p split into two bf16 parts none does.  So the bf16
    kernel's p·v takes two bf16 products, and its bound counts two."""
    q, k, v = (bf16(t) for t in _qkv(0))
    q = bf16(q * scale)
    want = tfa.flash_attention_ref(*(t.to(torch.bfloat16) for t in (q, k, v)))
    ratio = bf16_attention_ratio(bf16_attention(q, k, v, pv_products), want)
    if pv_products == 1:
        assert int((ratio > 1).sum()) > 1000
    else:
        assert ratio.max().item() <= 1.0


# ------------------------------------------------------------------ SSD
def ssd_chunked(x, dt, a_log, b, c, chunk, mm):
    """The kernel's chunked SSD over (BH, L, P) rows of one batch (B, C
    (L, N) shared by the heads), every product through ``mm``: the prefix
    sums of the fp32 dt·a in fp64, each difference rounded to fp32 once,
    G = C·Bᵀ, y = (G ∘ decay ∘ mask)·xd + exp(cum)·(C·Sᵀ), the state
    S' = exp(cum_Q) S + (w ∘ xd)ᵀ·B."""
    bh, l, p = x.shape
    q = chunk
    a = -torch.exp(a_log.to(F32).reshape(bh, 1))
    mask = torch.arange(q)[None, :] <= torch.arange(q)[:, None]
    state = torch.zeros(bh, p, b.shape[-1])
    ys = []
    for z in range(l // q):
        t = slice(z * q, (z + 1) * q)
        d = dt[:, t]
        xd = x[:, t] * d[..., None]
        cum = torch.cumsum((d * a).double(), dim=1)
        diff = (cum[:, :, None] - cum[:, None, :]).to(F32)
        decay = torch.exp(torch.where(mask, diff, -1e30))
        g = mm(c[t], b[t].T)                              # (Q, Q), shared
        y = mm(g * decay, xd)
        y = y + torch.exp(cum.to(F32))[..., None] * mm(
            c[t], state.transpose(1, 2))
        w = torch.exp((cum[:, -1:] - cum).to(F32))
        state = (torch.exp(cum[:, -1].to(F32))[:, None, None] * state
                 + mm((xd * w[..., None]).transpose(1, 2), b[t]))
        ys.append(y)
    return torch.cat(ys, dim=1)


def ssd_ratio(got, want):
    """err / bound under ``ssd_close``'s tolerance: rtol 2e-4, atol 2e-5 ·
    max(1, max|y|)."""
    bound = 2e-5 * max(1.0, want.abs().max().item()) + 2e-4 * want.abs()
    return (got - want).abs() / bound


def _ssd(seed, a_shift, l=1024, h=4, p=64, n=128):
    """(B, L, H, P, N) = (1, 1024, 4, 64, 128) drawn like the card tests:
    x ~ N(0, 1), dt = softplus(N(0, 1)), a_log ~ 0.5 N(0, 1) (+ a_shift),
    B, C ~ 0.3 N(0, 1); as (BH, L, P) rows and (L, N) B, C."""
    rng = np.random.RandomState(seed)
    x = rng.randn(h, l, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(h, l))).astype(np.float32)
    a_log = (rng.randn(h) * 0.5 + a_shift).astype(np.float32)
    bb = (rng.randn(l, n) * 0.3).astype(np.float32)
    cc = (rng.randn(l, n) * 0.3).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, a_log, bb, cc)]


def _ssd_ratio(mm, a_shift):
    x, dt, a_log, bb, cc = _ssd(3, a_shift)
    want = tss.ssd_scan_ref(x, dt, a_log[:, None], bb[None], cc[None],
                            chunk=256, num_heads=x.shape[0])
    got = ssd_chunked(x, dt, a_log, bb, cc, 256, mm)
    return ssd_ratio(got, want).max().item()


@pytest.mark.parametrize("a_shift", [0.0, 1.5])
def test_one_tf32_product_fails_the_ssd_tolerance(a_shift):
    """(1, 1024, 4, 64, 128) at Q = 256, with and without a_log + 1.5
    (cum below −100 inside a chunk): one TF32 product fails ``ssd_close``'s
    tolerance."""
    assert _ssd_ratio(mm_tf32, a_shift) > 2.0


@pytest.mark.parametrize("a_shift", [0.0, 1.5])
def test_split_products_pass_the_ssd_tolerance(a_shift):
    """The same through the three-product split: within half of the
    tolerance, and where the fp32 products themselves land through this
    form."""
    ratio = _ssd_ratio(mm_split, a_shift)
    assert ratio <= 0.5
    assert abs(ratio - _ssd_ratio(torch.matmul, a_shift)) <= 0.05


# ------------------------------------------------------------ the split
def test_bf16_values_are_exact_in_tf32():
    """A bf16 value (8 significant bits) is its own TF32 rounding: hi = x
    and the remainder is exactly 0, so a bf16 operand needs no lo term."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4096).astype(np.float32) *
                         np.exp(rng.randn(4096) * 8).astype(np.float32))
    x = x.to(torch.bfloat16).to(F32)
    hi, lo = split(x)
    assert torch.equal(hi, x)
    assert int(torch.count_nonzero(lo)) == 0


def test_split_holds_fp32_to_22_bits():
    """hi + lo holds an fp32 x to 2^-22 relative (hi keeps 11 significant
    bits, lo the next 11), and hi alone only to 2^-11."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1 << 16).astype(np.float32))
    hi, lo = split(x)
    rel = lambda y: ((y.double() - x.double()).abs()  # noqa: E731
                     / x.double().abs()).max().item()
    assert rel(hi + lo) <= 2.0 ** -22
    assert 2.0 ** -13 < rel(hi) <= 2.0 ** -11
