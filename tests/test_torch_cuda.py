"""PyTorch port, CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
visible — the kernels are built with nvcc and run only on the card.  No
JAX here, so the file runs on a machine with PyTorch alone:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Required: bitwise equality with ``kernels/torch_update`` (the libraries
are built with -fmad=false, IEEE division and sqrt), on a tile-aligned and
a ragged row count, with and without Δ (and B), wd 0 and non-zero, fp32
and bf16 moments, nesterov on and off, several β and k_eff; for the EF
round trip int8 and top-k (k = 8, 64, 256), with and without ref and EF,
with rows of ± ties, all-zero rows and rows with fewer than k non-zeros;
for the overlap fold vrl, bvr (β = 0.5, 1) and avg, capture on and off,
the miss mask mixed 0/1 over the workers and pend_k ∈ {1, 2, 3}; for the
hierarchy's four kernels over (P, D, R, C) grids — (2, 3) and (3, 2) pods
× workers, one worker per pod and one pod, tile-aligned and ragged rows —
wd 0 and non-zero, several k_eff, the fold with and without capture and
the miss mask all 0, all 1 and mixed over the pods; SM3-factored Adam
(flat and hierarchical) over S ∈ {1, 2, 5} lane-stat spans (flat; {1, 2}
hier), with rows holding a planted NaN compared NaN for NaN, and the
hierarchy's momentum (nesterov on and off) and dense Adam steps; the
hierarchy's EF round trips (grid form, a (P, 1, R, C) ref per pod) over
the four grids, int8 and top-k, with rows holding a NaN compared NaN for
NaN, and the flat round trip on the strided pod rows ``params[:, 0]``
that level 2 compresses; the tree-update API's per-leaf pair
(``vrl_local_update``, ``vrl_sync_update``) at ragged sizes, on views one
element off 16-byte alignment, fp32 and bf16 operands, x̂ broadcast over
the worker axes, NaN for NaN, and one launch per leaf of a tree.

The attention kernel (``csrc/flash_attention.cu``, behind
``kernels.mha_flash`` and ``kernels/flash_attention.flash_attention``) is
held to a tolerance, not bitwise (its online softmax sums in another order
than the one-pass plain version): fp32 rtol 2e-4 / atol 2e-5, bf16 one
bf16 ulp of the output beyond that fp32 tolerance (an output near zero is
a cancelling sum, whose fp32 error is more than a bf16 ulp there); over
ragged S, GQA groups 1, 2 and 7, D 16, 32, 64 and 128, causal on and off,
windows, views of a fused qkv buffer, scores of large magnitude (q · 10)
and D = 128 at S = 2048; and every head dim up to 256: the instantiations
80, 96, 112 and 256, widths between them zero-padded (40, 72, 200) and
bf16 rows that are not 16 bytes (36, 100), D = 80, 112, 256 and 72 at
S = 2048; the wrapper raises on a head dim past 256 or a dtype the kernel
does not take.

The SSD scan kernel (``csrc/ssd_scan.cu``, behind ``kernels.ssd_chunk_scan``
and ``kernels/ssd_scan.ssd_scan``) is held to its plain version within
fp32 rtol 2e-4 and atol 2e-5 · max(1, max|y|) (the reference tests'
tolerance on unit-scale outputs, scaled with the output: cum falls by
hundreds within a chunk at Q = 256, and ulp(|cum|) in each fp32 decay of
the plain version is of that order), bf16 one bf16 ulp beyond that; over
B 1-2, H 1-4, P 8-128, N 4-256, Q 16-256 with 1-8 chunks, ragged L (a
short last chunk), an a_log that drives cum below −100 inside a chunk,
views of a fused buffer, mixed dtypes of x, dt, B and C, mamba2-370m's
layer-0 width (4, 2048, 32, 64, 128), P = 128 with N = 256 (two P
slices), hymba-1.5b's (64, 16) and odd pairs; the host-side shared-memory
count equals the source's; the wrapper raises on what the kernel does
not take (P > 128, N > 256, N = 256 at a chunk past the shared memory).  Both kernels take their products on the tensor cores, fp32
operands split into two TF32 parts (csrc/split_mma.cuh); the tolerances
are those of the first, CUDA-core ports.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

W, R, C = 3, 16, 256
LOCAL_CASES = [(use_d, lr, wd) for use_d in (False, True)
               for lr, wd in ((0.05, 0.0), (0.05, 1e-4), (0.2, 1e-4))]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, r):
    rng = np.random.RandomState(seed)
    p, g, d = (rng.randn(W, r, C).astype(np.float32) for _ in range(3))
    xbar = rng.randn(r, C).astype(np.float32)
    return p, g, d, xbar


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
@pytest.mark.parametrize("r", [R, 1237])
def test_cuda_kernels_local_sgd_bitwise(use_d, lr, wd, r):
    dev = _cuda_or_skip()
    p, g, d, _ = (torch.from_numpy(x).to(dev) for x in _inputs(5, r=r))
    d = d if use_d else None
    want = tu.fused_local_sgd(p, g, d, lr=lr, wd=wd)
    n0 = tvu.LAUNCHES["fused_local_sgd"]
    got = tvu.fused_local_sgd(p, g, d, lr=lr, wd=wd)
    torch.cuda.synchronize()
    assert tvu.LAUNCHES["fused_local_sgd"] == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [R, 1237])
def test_cuda_kernels_sync_vrl_bitwise(r):
    dev = _cuda_or_skip()
    p, _, d, xbar = (torch.from_numpy(x).to(dev) for x in _inputs(6, r=r))
    scal = torch.full((1, 1), 3.0, device=dev) * 0.05
    want_p, want_d = tu.fused_sync_vrl(p, xbar, d, scal)
    n0 = tvu.LAUNCHES["fused_sync_vrl"]
    got_p, got_d = tvu.fused_sync_vrl(p, xbar, d, scal)
    torch.cuda.synchronize()
    assert tvu.LAUNCHES["fused_sync_vrl"] == n0 + 1
    assert torch.equal(got_p, want_p) and torch.equal(got_d, want_d)


MW, MR = 4, 4096                # the new kernels' moderate shape
MOMENT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _state(seed, r, dev, n=6):
    """n (MW, r, C) fp32 tensors and one (r, C) on ``dev``, from numpy."""
    rng = np.random.RandomState(seed)
    bufs = [torch.from_numpy(rng.randn(MW, r, C).astype(np.float32)).to(dev)
            for _ in range(n)]
    xbar = torch.from_numpy(rng.randn(r, C).astype(np.float32)).to(dev)
    return bufs, xbar


def _launched(name, fn):
    n0 = tvu.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert tvu.LAUNCHES[name] == n0 + 1
    return out


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("corr", ["none", "d", "db"])
@pytest.mark.parametrize("wd,nesterov", [(0.0, False), (1e-4, False),
                                         (1e-4, True)])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_local_momentum_bitwise(mdt, corr, wd, nesterov, r):
    dev = _cuda_or_skip()
    (p, g, d, b, m, _), _ = _state(7, r, dev)
    d = d if "d" in corr else None
    b = b if "b" in corr else None
    m = (0.1 * m).to(MOMENT_DTYPES[mdt])
    kw = dict(lr=0.05, beta=0.9, wd=wd, nesterov=nesterov, b=b)
    want = tu.fused_local_momentum(p, g, d, m, **kw)
    got = _launched("fused_local_momentum", lambda: tvu.fused_local_momentum(
        p.clone(), g, d, m.clone(), **kw))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("corr", ["none", "d", "db"])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_local_adam_bitwise(mdt, corr, wd, t, r):
    from repro_torch.optim import adam_scal
    dev = _cuda_or_skip()
    (p, g, d, b, mu, nu), _ = _state(8, r, dev)
    d = d if "d" in corr else None
    b = b if "b" in corr else None
    mu = (0.1 * mu).to(MOMENT_DTYPES[mdt])
    nu = (0.01 * nu * nu).to(MOMENT_DTYPES[mdt])
    scal = adam_scal(t, dev)
    kw = dict(lr=1e-3, wd=wd, b=b)
    want = tu.fused_local_adam(p, g, d, mu, nu, scal, **kw)
    got = _launched("fused_local_adam", lambda: tvu.fused_local_adam(
        p.clone(), g, d, mu.clone(), nu.clone(), scal, **kw))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.5, 1.0])
@pytest.mark.parametrize("k_eff", [1, 2, 3])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_sync_bvr_bitwise(beta, k_eff, r):
    dev = _cuda_or_skip()
    (p, d, b, *_), xbar = _state(9, r, dev, n=3)
    scal = torch.full((1, 1), float(k_eff), device=dev) * 0.05
    want = tu.fused_sync_bvr(p, xbar, d, b, scal, beta=beta)
    got = _launched("fused_sync_bvr", lambda: tvu.fused_sync_bvr(
        p.clone(), xbar, d.clone(), b.clone(), scal, beta=beta))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.3, 0.9])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_sync_easgd_bitwise(alpha, r):
    dev = _cuda_or_skip()
    (p, *_), xbar = _state(10, r, dev, n=1)
    center = p.mean(dim=0) + 0.5
    a = alpha / MW
    want = tu.fused_sync_easgd(p, xbar, center, a=a, na=MW * a)
    got = _launched("fused_sync_easgd", lambda: tvu.fused_sync_easgd(
        p.clone(), xbar, center.clone(), a=a, na=MW * a))
    _assert_equal(got, want)


def _special_rows(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Rows 0-3 of every worker: ± ties at the top magnitudes, all zeros,
    fewer than k non-zeros, and ±1 at scale 2 (int8: exact .5 levels)."""
    x = x.copy()
    x[:, 0] *= 0.1
    x[:, 0, :6] = [3.0, -3.0, 3.0, -2.5, 2.5, 2.5]
    x[:, 1] = 0.0
    x[:, 2] = 0.0
    x[:, 2, :k // 2] = np.linspace(0.5, 1.0, k // 2)
    x[:, 3] = np.where(np.arange(x.shape[-1]) % 2, 1.0, -1.0)
    x[:, 3, 0] = 127.0 * 2.0
    return x


EF_MODES = ["int8", "topk:8", "topk:64", "topk:256"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", EF_MODES)
@pytest.mark.parametrize("use_ref,use_e", [(False, False), (False, True),
                                           (True, False), (True, True)])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_ef_bitwise(mode, use_ref, use_e, r):
    dev = _cuda_or_skip()
    rng = np.random.RandomState(11)
    p = torch.from_numpy(_special_rows(
        rng.randn(MW, r, C).astype(np.float32))).to(dev)
    ref = torch.from_numpy(
        0.1 * rng.randn(r, C).astype(np.float32)).to(dev) if use_ref else None
    e = torch.from_numpy(
        0.01 * rng.randn(MW, r, C).astype(np.float32)).to(dev) if use_e \
        else None
    if mode == "int8":
        name, kw = "fused_ef_int8", {}
    else:
        name, kw = "fused_ef_topk", {"k": int(mode.split(":")[1])}
    want = getattr(tu, name)(p, ref, e, **kw)
    e2 = None if e is None else e.clone()
    dec, res = _launched(name, lambda: getattr(tvu, name)(p, ref, e2, **kw))
    assert torch.equal(dec, want[0])
    assert (res is None) == (want[1] is None)
    if res is not None:
        assert res is e2 and torch.equal(res, want[1])
        assert torch.equal(res + dec, want[1] + want[0])
    # dec written over the payload buffer itself (the engine's S-SGD path)
    p2 = p.clone()
    e3 = None if e is None else e.clone()
    dec2, _ = _launched(name, lambda: getattr(tvu, name)(p2, ref, e3,
                                                          out=p2, **kw))
    assert dec2 is p2 and torch.equal(p2, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vrl", "bvr0.5", "bvr1", "avg"])
@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("r", [MR, 1237])
def test_cuda_kernels_fold_overlap_bitwise(kind, capture, r):
    dev = _cuda_or_skip()
    (p, pend, d, b, *_), xbar = _state(12, r, dev, n=4)
    pend_k = torch.tensor([1.0, 2.0, 3.0, 2.0], device=dev)[:MW]
    inv = torch.reciprocal(pend_k * 0.05)[:, None]
    km = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)[:MW, None]
    wscal = torch.cat([inv, km], dim=1).contiguous()
    if kind == "avg":
        name, args, kw = "fused_fold_overlap_avg", (p, xbar, pend, wscal), {}
        inplace = (0, 2)
    elif kind == "vrl":
        name, args, kw = ("fused_fold_overlap", (p, xbar, pend, d, wscal),
                          {})
        inplace = (0, 2, 3)
    else:
        name = "fused_fold_overlap_bvr"
        args, kw = (p, xbar, pend, d, b, wscal), {"beta": float(kind[3:])}
        inplace = (0, 2, 3, 4)
    want = getattr(tu, name)(*args, capture=capture, **kw)
    got_args = [a.clone() if i in inplace else a for i, a in enumerate(args)]
    got = _launched(name, lambda: getattr(tvu, name)(*got_args,
                                                     capture=capture, **kw))
    assert len(got) == len(want)
    _assert_equal(got, want)
    if not capture:
        assert torch.equal(got_args[2], pend)     # pend left as it was


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "topk:8"])
@pytest.mark.parametrize("c", [128, 512, 1024])
def test_cuda_kernels_ef_other_lane_counts(mode, c):
    """Rows of 128, 512 and 1,024 lanes (``EngineConfig.lanes``): one, four
    and eight float4 groups per lane of the warp."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(13)
    p, e = (torch.from_numpy(rng.randn(MW, 333, c).astype(np.float32))
            .to(dev) for _ in range(2))
    ref = torch.from_numpy(rng.randn(333, c).astype(np.float32)).to(dev)
    p[:, 0] = 0.0
    if mode == "int8":
        name, kw = "fused_ef_int8", {}
    else:
        name, kw = "fused_ef_topk", {"k": int(mode.split(":")[1])}
    want = getattr(tu, name)(p, ref, e, **kw)
    got = _launched(name, lambda: getattr(tvu, name)(p, ref, e.clone(),
                                                     **kw))
    _assert_equal(got, want)


# ------------------------------------------------ hierarchy (P, D, R, C)
GRIDS = [(2, 3, MR), (3, 2, 1237), (4, 1, MR), (1, 4, 1237)]


def _grid_state(seed, grid, dev):
    """p, g, d1 (P, D, r, C); d2, x̂_pod, pend2 (P, 1, r, C); glob (r, C),
    fp32 from numpy on ``dev``."""
    pp, dd, r = grid
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    return ([arr(pp, dd, r, C) for _ in range(3)]
            + [arr(pp, 1, r, C) for _ in range(3)] + [arr(r, C)])


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_hier_local_sgd_bitwise(wd, grid):
    dev = _cuda_or_skip()
    p, g, d1, d2, *_ = _grid_state(14, grid, dev)
    want = tu.fused_hier_local_sgd(p, g, d1, d2, lr=0.05, wd=wd)
    got = _launched("fused_hier_local_sgd", lambda: tvu.fused_hier_local_sgd(
        p.clone(), g, d1, d2, lr=0.05, wd=wd))
    _assert_equal((got,), (want,))


@pytest.mark.cuda
@pytest.mark.parametrize("k_eff", [1, 2, 3])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_sync_hier1_bitwise(k_eff, grid):
    dev = _cuda_or_skip()
    p, _, d1, _, xpod, *_ = _grid_state(15, grid, dev)
    scal = torch.full((1, 1), float(k_eff), device=dev) * 0.05
    want = tu.fused_sync_hier1(p, xpod, d1, scal)
    got = _launched("fused_sync_hier1", lambda: tvu.fused_sync_hier1(
        p.clone(), xpod, d1.clone(), scal))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k_eff", [1, 2])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_sync_hier2_bitwise(k_eff, grid):
    dev = _cuda_or_skip()
    p, _, _, d2, _, _, glob = _grid_state(16, grid, dev)
    scal = torch.full((1, 1), float(k_eff), device=dev) * 0.05
    want = tu.fused_sync_hier2(p, glob, d2, scal)
    got = _launched("fused_sync_hier2", lambda: tvu.fused_sync_hier2(
        p.clone(), glob, d2.clone(), scal))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("km", ["0", "1", "mixed"])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_fold_overlap_hier2_bitwise(capture, km, grid):
    dev = _cuda_or_skip()
    p, _, _, d2, _, pend, glob = _grid_state(17, grid, dev)
    pods = grid[0]
    pend_k = torch.tensor([1.0, 2.0, 3.0, 2.0], device=dev)[:pods]
    inv = torch.reciprocal(pend_k * 0.05)[:, None]
    miss = {"0": [0.0] * 4, "1": [1.0] * 4, "mixed": [0.0, 1.0, 1.0, 0.0]}
    kmt = torch.tensor(miss[km], device=dev)[:pods, None]
    wscal = torch.cat([inv, kmt], dim=1).contiguous()
    want = tu.fused_fold_overlap_hier2(p, glob, pend, d2, wscal,
                                       capture=capture)
    bufs = [x.clone() for x in (p, pend, d2)]
    got = _launched("fused_fold_overlap_hier2",
                    lambda: tvu.fused_fold_overlap_hier2(
                        bufs[0], glob, bufs[1], bufs[2], wscal,
                        capture=capture))
    assert len(got) == len(want)
    _assert_equal(got, want)
    if not capture:
        assert torch.equal(bufs[1], pend)          # pend2 left as it was


# ------------------------------------------ SM3 Adam, hier momentum and Adam
def _equal_nan(got, want):
    """Bitwise, NaN for NaN (a NaN's payload is not compared)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        nan = torch.isnan(a.float())
        assert torch.equal(nan, torch.isnan(b.float()))
        assert torch.equal(a[~nan], b[~nan])


def _adam_scal(dev, t=3):
    return torch.tensor([[1 - 0.9 ** t, 1 - 0.999 ** t]], dtype=torch.float32,
                        device=dev)


def _stats(rng, lead, r, shards, dev):
    """SM3's row (lead, r, 1) and lane (lead, S, C) stats, ≥ 0."""
    row = 0.01 * np.square(rng.randn(*lead, r, 1)).astype(np.float32)
    col = 0.01 * np.square(rng.randn(*lead, shards, C)).astype(np.float32)
    return torch.from_numpy(row).to(dev), torch.from_numpy(col).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("corr", ["none", "d", "db"])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("shards", [1, 2, 5])
@pytest.mark.parametrize("r", [MR, 1235])
def test_cuda_kernels_local_adam_sm3_bitwise(mdt, corr, wd, shards, r):
    dev = _cuda_or_skip()
    rows = r - r % shards
    (p, g, d, b, mu, _), _ = _state(18, rows, dev)
    d = d if "d" in corr else None
    b = b if "b" in corr else None
    mu = (0.1 * mu).to(MOMENT_DTYPES[mdt])
    row, col = _stats(np.random.RandomState(19), (MW,), rows, shards, dev)
    kw = dict(lr=1e-3, wd=wd, b=b)
    scal = _adam_scal(dev)
    want = tu.fused_local_adam_sm3(p, g, d, mu, row, col, scal, **kw)
    got = _launched("fused_local_adam_sm3", lambda: tvu.fused_local_adam_sm3(
        p.clone(), g, d, mu.clone(), row.clone(), col, scal, **kw))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_cuda_kernels_adam_sm3_nan_rows(shards):
    """A planted NaN in g reaches p, mu, the row stat and its span's lane
    stat as in the plain version (compared NaN for NaN)."""
    dev = _cuda_or_skip()
    (p, g, d, _, mu, _), _ = _state(20, MR, dev)
    g[1, 7, 33] = float("nan")
    g[2, MR - 1, 255] = float("nan")
    row, col = _stats(np.random.RandomState(21), (MW,), MR, shards, dev)
    scal = _adam_scal(dev)
    want = tu.fused_local_adam_sm3(p, g, d, mu, row, col, scal, lr=1e-3)
    got = _launched("fused_local_adam_sm3", lambda: tvu.fused_local_adam_sm3(
        p.clone(), g, d, mu.clone(), row.clone(), col, scal, lr=1e-3))
    _equal_nan(got, want)
    assert torch.isnan(got[2]).sum().item() == 2


SM3_GRIDS = [(2, 3, MR), (3, 2, 1236), (4, 1, MR), (1, 4, 1236)]


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("wd,nesterov", [(0.0, False), (1e-4, False),
                                         (1e-4, True)])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_hier_local_momentum_bitwise(mdt, wd, nesterov, grid):
    dev = _cuda_or_skip()
    p, g, d1, d2, *_ = _grid_state(22, grid, dev)
    m = (0.1 * g).to(MOMENT_DTYPES[mdt])
    kw = dict(lr=0.05, beta=0.9, wd=wd, nesterov=nesterov)
    want = tu.fused_hier_local_momentum(p, g, d1, d2, m, **kw)
    got = _launched("fused_hier_local_momentum",
                    lambda: tvu.fused_hier_local_momentum(
                        p.clone(), g, d1, d2, m.clone(), **kw))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_hier_local_adam_bitwise(mdt, wd, t, grid):
    dev = _cuda_or_skip()
    p, g, d1, d2, *_ = _grid_state(23, grid, dev)
    mu = (0.1 * g).to(MOMENT_DTYPES[mdt])
    nu = (0.01 * d1.square()).to(MOMENT_DTYPES[mdt])
    scal = _adam_scal(dev, t)
    want = tu.fused_hier_local_adam(p, g, d1, d2, mu, nu, scal, lr=1e-3,
                                    wd=wd)
    got = _launched("fused_hier_local_adam", lambda: tvu.fused_hier_local_adam(
        p.clone(), g, d1, d2, mu.clone(), nu.clone(), scal, lr=1e-3, wd=wd))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("grid", SM3_GRIDS)
def test_cuda_kernels_hier_local_adam_sm3_bitwise(mdt, wd, shards, grid):
    dev = _cuda_or_skip()
    p, g, d1, d2, *_ = _grid_state(24, grid, dev)
    pp, dd, r = grid
    mu = (0.1 * g).to(MOMENT_DTYPES[mdt])
    row, col = _stats(np.random.RandomState(25), (pp, dd), r, shards, dev)
    scal = _adam_scal(dev)
    want = tu.fused_hier_local_adam_sm3(p, g, d1, d2, mu, row, col, scal,
                                        lr=1e-3, wd=wd)
    got = _launched("fused_hier_local_adam_sm3",
                    lambda: tvu.fused_hier_local_adam_sm3(
                        p.clone(), g, d1, d2, mu.clone(), row.clone(), col,
                        scal, lr=1e-3, wd=wd))
    _assert_equal(got, want)


# ------------------------------- the hierarchy's EF round trips (grid form)
EF_GRID_MODES = ["int8", "topk:8", "topk:64", "topk:256"]


def _grid_ef_inputs(seed, grid, dev):
    """p (P, D, r, C) with the special rows and a NaN row in every worker,
    ref (P, 1, r, C), e (P, D, r, C)."""
    pp, dd, r = grid
    rng = np.random.RandomState(seed)
    p = _special_rows(rng.randn(pp * dd, r, C).astype(np.float32))
    p[:, 5, 7] = np.nan
    ref = 0.1 * rng.randn(pp, 1, r, C).astype(np.float32)
    e = 0.01 * rng.randn(pp, dd, r, C).astype(np.float32)
    return (torch.from_numpy(p.reshape(pp, dd, r, C)).to(dev),
            torch.from_numpy(ref).to(dev), torch.from_numpy(e).to(dev))


def _ef_name(mode, grid=True):
    name = "fused_ef_int8" if mode == "int8" else "fused_ef_topk"
    kw = {} if mode == "int8" else {"k": int(mode.split(":")[1])}
    return name + ("_grid" if grid else ""), kw


@pytest.mark.cuda
@pytest.mark.parametrize("mode", EF_GRID_MODES)
@pytest.mark.parametrize("use_ref,use_e", [(False, False), (False, True),
                                           (True, False), (True, True)])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_ef_grid_bitwise(mode, use_ref, use_e, grid):
    """Bitwise the plain version, NaN rows NaN for NaN; ref is the pod's,
    read once per pod; out= and e in place."""
    dev = _cuda_or_skip()
    p, ref, e = _grid_ef_inputs(31, grid, dev)
    ref = ref if use_ref else None
    e = e if use_e else None
    name, kw = _ef_name(mode)
    want = getattr(tu, name)(p, ref, e, **kw)
    e2 = None if e is None else e.clone()
    out = torch.empty_like(p)
    got = _launched(name, lambda: getattr(tvu, name)(p, ref, e2, out=out,
                                                     **kw))
    assert got[0] is out and (got[1] is e2)
    _equal_nan([x for x in got if x is not None],
               [x for x in want if x is not None])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "topk:8"])
@pytest.mark.parametrize("grid", GRIDS)
def test_cuda_kernels_ef_flat_on_pod_rows(mode, grid):
    """Level 2's round trip: the flat kernel over the strided pod rows
    params[:, 0] of a (P, D, R, C) buffer, with a shared (R, C) ref and the
    contiguous resid2[:, 0], bitwise the plain version on a copy."""
    dev = _cuda_or_skip()
    p, ref, e = _grid_ef_inputs(32, grid, dev)
    pod, ref2, e2 = p[:, 0], ref[0, 0], e[:, :1].clone()
    name, kw = _ef_name(mode, grid=False)
    want = getattr(tu, name)(pod.contiguous(), ref2, e2[:, 0].clone(), **kw)
    got = _launched(name, lambda: getattr(tvu, name)(pod, ref2, e2[:, 0],
                                                     **kw))
    _equal_nan(got, want)
    _equal_nan([e2[:, 0]], [want[1]])


# ------------------------------------ the per-leaf pair (tree-update API)
LEAF_SHAPES = [(64, 64), (1000,), (3, 5, 7), (4, 130, 7), (1,), (105,),
               (2 ** 16 + 3,)]
LEAF_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaf_inputs(seed, shape, dev, dts=("f32", "f32", "f32"), nan=False,
                 offset=0):
    """Three operands of ``shape`` in the dtypes ``dts``, from numpy; with
    ``offset`` each is a view one element into a larger buffer (not
    16-byte aligned); with ``nan`` a NaN planted in each."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    out = []
    for i, dt in enumerate(dts):
        x = rng.randn(n + offset).astype(np.float32)
        if nan:
            x[offset + (7 * i) % n] = np.nan
        t = torch.from_numpy(x).to(dev).to(LEAF_DTYPES[dt])
        out.append(t[offset:].view(shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LEAF_SHAPES)
@pytest.mark.parametrize("dts", [("f32", "f32", "f32"),
                                 ("bf16", "bf16", "f32"),
                                 ("bf16", "f32", "bf16"),
                                 ("f32", "bf16", "bf16")])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernels_leaf_local_bitwise(shape, dts, offset):
    """vrl_local_update bitwise its plain version, ragged sizes and views
    one element off 16-byte alignment included; Δ rounded to p's dtype in
    the kernel."""
    dev = _cuda_or_skip()
    p, g, d = _leaf_inputs(41, shape, dev, dts, offset=offset)
    assert offset == 0 or p.data_ptr() % 16
    want = tu.vrl_local_update(p, g, d, lr=0.03)
    got = _launched("vrl_local_update",
                    lambda: tvu.vrl_local_update(p, g, d, lr=0.03))
    _assert_equal([got], [want])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LEAF_SHAPES)
@pytest.mark.parametrize("dts", [("f32", "f32", "f32"),
                                 ("bf16", "bf16", "f32"),
                                 ("bf16", "f32", "bf16")])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernels_leaf_sync_bitwise(shape, dts, offset):
    """vrl_sync_update bitwise its plain version at k = 3, γ = 0.07, x̂ of
    p's shape."""
    dev = _cuda_or_skip()
    p, xb, d = _leaf_inputs(42, shape, dev, dts, offset=offset)
    inv_kg = 1.0 / (3 * 0.07)
    want = tu.vrl_sync_update(p, xb, d, inv_kg=inv_kg)
    got = _launched("vrl_sync_update",
                    lambda: tvu.vrl_sync_update(p, xb, d, inv_kg=inv_kg))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,shape", [((4,), (130, 7)), ((3,), (1000,)),
                                        ((2, 2), (64, 64)), ((4,), (3,)),
                                        ((2,), (2 ** 16 + 3,))])
@pytest.mark.parametrize("dts", [("f32", "f32", "f32"),
                                 ("bf16", "bf16", "f32")])
def test_cuda_kernels_leaf_sync_broadcast_xbar(lead, shape, dts):
    """x̂ shaped like p without its worker axes, read with a stride of 0
    over them: bitwise the plain version on the broadcast."""
    dev = _cuda_or_skip()
    p, _, d = _leaf_inputs(43, lead + shape, dev, dts)
    xb = _leaf_inputs(44, shape, dev, (dts[1],))[0]
    want = tu.vrl_sync_update(p, xb, d, inv_kg=1.0 / (2 * 0.05))
    got = _launched("vrl_sync_update",
                    lambda: tvu.vrl_sync_update(p, xb, d,
                                                inv_kg=1.0 / (2 * 0.05)))
    _assert_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (1000,), (4, 130, 7)])
@pytest.mark.parametrize("p_dt", ["f32", "bf16"])
def test_cuda_kernels_leaf_nan_rows(shape, p_dt):
    """NaN in p, g, Δ or x̂ reaches the outputs where the plain version
    has it, NaN for NaN."""
    dev = _cuda_or_skip()
    dts = (p_dt, p_dt, "f32")
    p, g, d = _leaf_inputs(45, shape, dev, dts, nan=True)
    want = tu.vrl_local_update(p, g, d, lr=0.1)
    got = _launched("vrl_local_update",
                    lambda: tvu.vrl_local_update(p, g, d, lr=0.1))
    assert torch.isnan(got.float()).any()
    _equal_nan([got], [want])
    want = tu.vrl_sync_update(p, g, d, inv_kg=1.0 / 0.3)
    got = _launched("vrl_sync_update",
                    lambda: tvu.vrl_sync_update(p, g, d, inv_kg=1.0 / 0.3))
    _equal_nan(got, want)


@pytest.mark.cuda
def test_cuda_kernels_leaf_tree_api_launches_per_leaf():
    """The tree-update API launches each kernel once per leaf, and its
    trees are bitwise the plain versions' leaf by leaf."""
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    shapes = {"a": (4, 64, 64), "b": {"c": (4, 1000), "d": (4, 3, 5, 7)}}

    def tree(seed):
        rng = np.random.RandomState(seed)

        def make(s):
            if isinstance(s, dict):
                return {k: make(v) for k, v in s.items()}
            return torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
        return make(shapes)
    from repro_torch import tree as tm
    p, g, d = tree(1), tree(2), tree(3)
    xb = tm.tree_map(lambda x: x.mean(dim=0, keepdim=True), p)
    n0 = dict(tvu.LAUNCHES)
    out = ops.vrl_local_update_tree(p, g, d, lr=0.05)
    po, do = ops.vrl_sync_update_tree(p, xb, d, k=3, lr=0.07)
    torch.cuda.synchronize()
    for name in ("vrl_local_update", "vrl_sync_update"):
        assert tvu.LAUNCHES[name] == n0[name] + 3
    inv_kg = 1.0 / (3 * 0.07)
    for a, b, c, x, o, op_, od in zip(*(tm.leaves(t) for t in (
            p, g, d, xb, out, po, do))):
        _assert_equal([o], [tu.vrl_local_update(a, b, c, lr=0.05)])
        _assert_equal([op_, od], tu.vrl_sync_update(a, x, c, inv_kg=inv_kg))


# ------------------------------------------------- attention (tolerance)
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), x in fp32."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e.clamp_min(-125) - 8)


def _assert_attention_close(got: torch.Tensor, want: torch.Tensor):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)
    else:
        ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
        bound = ulp + 2e-5 + 2e-4 * w.abs()
        assert int(((g - w).abs() > bound).sum()) == 0


def _mha_inputs(seed, b, s, h, kvh, d, dev, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32)).to(
        device=dev, dtype=dtype) for n in (h, kvh, kvh)]


FLASH_CASES = [
    # b, s, h, kvh, d, causal, window
    (1, 1, 2, 1, 64, True, None),
    (2, 100, 4, 2, 16, True, None),
    (1, 257, 7, 1, 32, True, 16),
    (2, 512, 4, 4, 64, True, 64),
    (1, 200, 2, 1, 128, True, None),
    (2, 130, 6, 3, 64, False, None),
    (1, 96, 2, 2, 32, False, 16),
    (1, 70, 2, 1, 16, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_mha_flash_matches_plain(case, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    b, s, h, kvh, d, causal, window = case
    q, k, v = _mha_inputs(s + d, b, s, h, kvh, d, dev, dtype)
    n0 = fa.LAUNCHES["flash_attention"]
    got = ops.mha_flash(q, k, v, causal=causal, window=window, block_q=64,
                        block_k=64)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    want = fa.mha_flash_ref(q, k, v, causal=causal, window=window,
                            block_q=64, block_k=64)
    _assert_attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_flash_attention_bhsd(d, dtype):
    """The (BH, S, D) wrapper, the reference kernel's own interface."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda_or_skip()
    q, k, v = (x[:, :, 0] for x in _mha_inputs(d, 6, 256, 1, 1, d, dev,
                                               dtype))
    for causal, window in ((True, None), (False, None), (True, 100)):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        _assert_attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_mha_flash_large_scores(causal, window, dtype):
    """q · 10: scores of magnitude ~80, a sharply peaked softmax, where
    the fp32 products' rounding moves p the most (the tensor-core split
    keeps them fp32-accurate; tests/test_torch_split_products.py)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    q, k, v = _mha_inputs(11, 2, 512, 4, 2, 64, dev, torch.float32)
    q, k, v = (q * 10).to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, window=window)
    _assert_attention_close(ops.mha_flash(q, k, v, **kw),
                            fa.mha_flash_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_mha_flash_d128_long(causal, window, dtype):
    """D = 128 over S = 2048: fp32 streams 32-key tiles with Q kept in
    shared memory, bf16 64-key tiles with Q in registers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    q, k, v = _mha_inputs(12, 1, 2048, 4, 2, 128, dev, dtype)
    kw = dict(causal=causal, window=window)
    _assert_attention_close(ops.mha_flash(q, k, v, **kw),
                            fa.mha_flash_ref(q, k, v, **kw))


@pytest.mark.cuda
def test_cuda_kernels_mha_flash_reads_views():
    """q, k, v as views of one fused (B, S, H + 2 KVH, D) buffer and a
    misaligned view: read through their strides (or copied), same result."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 150, 8, 64).astype(np.float32)).to(
        dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    want = fa.mha_flash_ref(q, k, v, block_q=64, block_k=64)
    _assert_attention_close(ops.mha_flash(q, k, v, block_q=64, block_k=64),
                            want)
    flat = torch.from_numpy(rng.randn(1 + 2 * 150 * 4 * 64).astype(
        np.float32)).to(dev)
    qm = flat[1:].view(2, 150, 4, 64)
    _assert_attention_close(
        ops.mha_flash(qm, k, v, block_q=64, block_k=64),
        fa.mha_flash_ref(qm, k, v, block_q=64, block_k=64))


# head dims past the first four instantiations: the new instantiations
# (80, 96, 112, 256: two passes of 128 output columns), and widths between
# them zero-padded to the next (40 -> 64, 72 -> 80, 200 -> 256; 36 and 100
# in bf16 are not 16-byte rows and are padded into a copy first)
WIDE_DIMS = [80, 96, 112, 256, 40, 72, 200, 36, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_mha_flash_wide_head_dims(d, causal, window, dtype):
    """Every head dim up to 256, GQA and a ragged S, one launch a call;
    the scale is D^-½ of the true D."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    q, k, v = _mha_inputs(d, 2, 300, 4, 2, d, dev, dtype)
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    n0 = fa.LAUNCHES["flash_attention"]
    got = ops.mha_flash(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    assert got.is_contiguous()
    _assert_attention_close(got, fa.mha_flash_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 112, 256, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_mha_flash_wide_long(d, dtype):
    """stablelm-3b's, kimi-k2's and gemma-7b's head dims and an odd one at
    S = 2048 (many key tiles a query tile), causal and window 512."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    q, k, v = _mha_inputs(100 + d, 1, 2048, 4, 2, d, dev, dtype)
    for window in (None, 512):
        _assert_attention_close(ops.mha_flash(q, k, v, window=window),
                                fa.mha_flash_ref(q, k, v, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_flash_attention_bhsd_wide(d, dtype):
    """The (BH, S, D) wrapper at the new widths."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda_or_skip()
    q, k, v = (x[:, :, 0] for x in _mha_inputs(d, 6, 256, 1, 1, d, dev,
                                               dtype))
    for causal, window in ((True, None), (False, None), (True, 100)):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        _assert_attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(257, torch.float32),
                                     (512, torch.bfloat16),
                                     (64, torch.float16),
                                     (64, torch.float64)])
def test_cuda_kernels_mha_flash_raises_on_what_it_does_not_take(d, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _cuda_or_skip()
    q = torch.zeros(1, 64, 2, d, device=dev, dtype=dtype)
    n0 = fa.LAUNCHES["flash_attention"]
    with pytest.raises((ValueError, TypeError)):
        ops.mha_flash(q, q, q, block_q=64, block_k=64)
    with pytest.raises(TypeError):
        ops.mha_flash(q, q.float() if dtype != torch.float32 else q.double(),
                      q, block_q=64, block_k=64)
    assert fa.LAUNCHES["flash_attention"] == n0


# ------------------------------------------------- ssd scan (tolerance)
def _assert_ssd_close(got: torch.Tensor, want: torch.Tensor):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    bound = 2e-5 * max(1.0, w.abs().max().item()) + 2e-4 * w.abs()
    if got.dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool(torch.isfinite(g).all())
    assert int(((g - w).abs() > bound).sum()) == 0, (g - w).abs().max()


def _ssd_inputs(seed, b, l, h, p, n, dev, dtype, a_scale=0.5, a_shift=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, l, h))).astype(np.float32)
    a_log = (rng.randn(h) * a_scale + a_shift).astype(np.float32)
    bb = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    cc = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    cast = [torch.from_numpy(t).to(device=dev, dtype=dtype)
            for t in (x, dt, bb, cc)]
    return cast[0], cast[1], torch.from_numpy(a_log).to(dev), cast[2], cast[3]


SSD_CASES = [
    # b, l, h, p, n, chunk
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 64),
    (2, 512, 2, 64, 128, 256),
    (1, 100, 3, 16, 8, 32),         # ragged: a short last chunk
    (2, 37, 1, 8, 4, 256),          # chunk = L
    (1, 2048, 1, 64, 128, 256),     # 8 chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_ssd_chunk_scan_matches_plain(case, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    b, l, h, p, n, q = case
    args = _ssd_inputs(l + p, b, l, h, p, n, dev, dtype)
    n0 = ss.LAUNCHES["ssd_scan"]
    got = ops.ssd_chunk_scan(*args, chunk=q)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == n0 + 1
    _assert_ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_ssd_chunk_scan_layer0_width(dtype):
    """mamba2-370m's layer-0 width, (B, L, H, P, N) = (4, 2048, 32, 64,
    128) at Q = 256: 8 chunks whose state crosses 7 boundaries, C·Bᵀ
    shared by 32 heads."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    args = _ssd_inputs(13, 4, 2048, 32, 64, 128, dev, dtype)
    n0 = ss.LAUNCHES["ssd_scan"]
    got = ops.ssd_chunk_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == n0 + 1
    _assert_ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=256))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_ssd_scan_bhlp(dtype):
    """The (BH, L, P) wrapper, the reference kernel's own interface, with a
    per-(batch, head) a_log."""
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    x, dt, a_log, bb, cc = _ssd_inputs(9, 2, 192, 3, 32, 16, dev, dtype)
    xt = x.transpose(1, 2).reshape(6, 192, 32).contiguous()
    dtt = dt.transpose(1, 2).reshape(6, 192).contiguous()
    alog = torch.randn(6, 1, generator=torch.Generator().manual_seed(2)).to(
        dev) * 0.5
    got = ss.ssd_scan(xt, dtt, alog, bb, cc, chunk=64, num_heads=3)
    _assert_ssd_close(got, ss.ssd_scan_ref(xt, dtt, alog, bb, cc, chunk=64,
                                           num_heads=3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_ssd_scan_overflow_case(dtype):
    """a_log ≈ 1.5 drives cum below −100 within 40 steps and to ~−900 by
    the end of a 256-step chunk: the factored exp(cum_i)·exp(−cum_j) would
    overflow fp32; the kernel's exp(cum_i − cum_j) does not."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    args = _ssd_inputs(4, 2, 512, 2, 64, 128, dev, dtype, a_scale=0.1,
                       a_shift=1.5)
    cum = (args[1].float() * torch.exp(args[2])).reshape(2, 2, 256, 2).sum(2)
    assert cum.min().item() > 100
    got = ops.ssd_chunk_scan(*args, chunk=256)
    _assert_ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=256))


_BF, _F = torch.bfloat16, torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(_BF, _F, _F, _F), (_F, _BF, _BF, _BF),
                                    (_BF, _F, _BF, _BF), (_F, _F, _BF, _F)])
def test_cuda_kernels_ssd_chunk_scan_mixed_dtypes(dtypes):
    """x, dt, B and C in mixed dtypes: a bf16 x with fp32 dt, B and C, the
    reverse, Mamba2's usual bf16 x, B, C with an fp32 dt, and B and C
    apart; each operand read up to fp32, y in x's dtype."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    x, dt, a_log, bb, cc = _ssd_inputs(12, 2, 300, 3, 64, 128, dev,
                                       torch.float32)
    args = (x.to(dtypes[0]), dt.to(dtypes[1]), a_log, bb.to(dtypes[2]),
            cc.to(dtypes[3]))
    n0 = ss.LAUNCHES["ssd_scan"]
    got = ops.ssd_chunk_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == n0 + 1 and got.dtype == dtypes[0]
    _assert_ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=256))


@pytest.mark.cuda
def test_cuda_kernels_ssd_chunk_scan_reads_views():
    """x and dt as views of fused buffers (strided heads and steps), read
    through their strides; the same result as contiguous copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    rng = np.random.RandomState(5)
    fused = torch.from_numpy(rng.randn(2, 150, 5, 32).astype(
        np.float32)).to(dev)
    x = fused[:, :, 1:4]
    dts = torch.from_numpy(np.log1p(np.exp(rng.randn(2, 150, 7))).astype(
        np.float32)).to(dev)
    dt = dts[:, :, 2:5]
    bc = torch.from_numpy(rng.randn(2, 150, 40).astype(np.float32) * 0.3).to(
        dev)
    bb, cc = bc[..., :16], bc[..., 20:36]
    a_log = torch.zeros(3, device=dev)
    want = ss.ssd_chunk_scan_ref(x.contiguous(), dt.contiguous(), a_log,
                                 bb.contiguous(), cc.contiguous(), chunk=64)
    _assert_ssd_close(ops.ssd_chunk_scan(x, dt, a_log, bb, cc, chunk=64),
                      want)


@pytest.mark.cuda
def test_cuda_kernels_ssd_scan_raises_on_what_it_does_not_take():
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    n0 = ss.LAUNCHES["ssd_scan"]
    x, dt, a_log, bb, cc = _ssd_inputs(1, 1, 32, 1, 129, 8, dev,
                                       torch.float32)
    with pytest.raises(ValueError):            # P = 129 > 128
        ops.ssd_chunk_scan(x, dt, a_log, bb, cc, chunk=16)
    x, dt, a_log, bb, cc = _ssd_inputs(1, 1, 32, 1, 16, 264, dev,
                                       torch.float32)
    with pytest.raises(ValueError):            # N = 264 > 256
        ops.ssd_chunk_scan(x, dt, a_log, bb, cc, chunk=16)
    x, dt, a_log, bb, cc = _ssd_inputs(1, 1, 3000, 1, 64, 256, dev,
                                       torch.float32)
    with pytest.raises(ValueError, match="widest N that fits"):
        ops.ssd_chunk_scan(x, dt, a_log, bb, cc, chunk=3000)
    x, dt, a_log, bb, cc = _ssd_inputs(1, 1, 32, 1, 16, 8, dev,
                                       torch.float32)
    with pytest.raises(TypeError):             # an fp16 dt
        ops.ssd_chunk_scan(x, dt.half(), a_log, bb, cc, chunk=16)
    with pytest.raises(TypeError):             # fp16
        ops.ssd_chunk_scan(*(t.half() for t in (x, dt)), a_log,
                           *(t.half() for t in (bb, cc)), chunk=16)
    assert ss.LAUNCHES["ssd_scan"] == n0


# (P, N) past the first port's domain: mamba-class P = 128 with N = 256
# (two 64-wide P slices, four 8-column state tiles a warp), hymba-1.5b's
# (64, 16), and odd pairs (P 80 -> slices of 64 and 16, N 200 -> 208)
WIDE_SSD_CASES = [
    # b, l, h, p, n, chunk
    (2, 512, 2, 128, 256, 256),
    (1, 300, 3, 128, 256, 64),      # ragged, 5 chunks
    (2, 1024, 4, 64, 16, 256),
    (1, 700, 2, 80, 200, 256),      # ragged
    (1, 96, 1, 100, 136, 96),       # one chunk
    (2, 256, 2, 48, 256, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_ssd_chunk_scan_wide(case, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    b, l, h, p, n, q = case
    assert ss.shape_supported(p, n, q)
    args = _ssd_inputs(l + p + n, b, l, h, p, n, dev, dtype)
    n0 = ss.LAUNCHES["ssd_scan"]
    got = ops.ssd_chunk_scan(*args, chunk=q)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == n0 + 1
    _assert_ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(_BF, _F, _BF, _BF), (_F, _F, _BF, _F)])
def test_cuda_kernels_ssd_chunk_scan_wide_mixed(dtypes):
    """(P, N) = (128, 256) with Mamba2's usual bf16 x, B, C and fp32 dt,
    and with bf16 B only."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    dev = _cuda_or_skip()
    x, dt, a_log, bb, cc = _ssd_inputs(21, 2, 600, 2, 128, 256, dev,
                                       torch.float32)
    args = (x.to(dtypes[0]), dt.to(dtypes[1]), a_log, bb.to(dtypes[2]),
            cc.to(dtypes[3]))
    _assert_ssd_close(ops.ssd_chunk_scan(*args, chunk=256),
                      ss.ssd_chunk_scan_ref(*args, chunk=256))


@pytest.mark.cuda
def test_cuda_kernels_ssd_smem_bytes_match_the_source():
    """``ssd_scan.smem_bytes`` (the host-side predicate's count) is the
    source's ``ssd_scan_smem_bytes`` at every P slice width, N, chunk and
    dtype mix."""
    from repro_torch.kernels import ssd_scan as ss
    _cuda_or_skip()
    lib = ss._lib()
    for p in (8, 32, 64, 128):
        for n in (4, 16, 128, 200, 256):
            for chunk in (16, 64, 256, 1000, 2474, 4096):
                for xb in (0, 1):
                    for bcb in (0, 1):
                        want = lib.ssd_scan_smem_bytes(p, n, chunk, xb, bcb)
                        assert ss.smem_bytes(p, n, chunk, 2 if xb else 4,
                                             2 if bcb else 4) == want, (
                            p, n, chunk, xb, bcb)


BACKBONE_ARCHS = ["stablelm-3b", "gemma-7b", "musicgen-large",
                  "chameleon-34b"]


def _backbone_inputs(cfg, b, s, seed):
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    if cfg.frontend == "codec":
        return torch.randn((b, s, cfg.frontend_dim), generator=gen), labels
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return toks, torch.roll(toks, -1, dims=-1)


def _loss_grads(cfg, params, x, labels, remat, chunk):
    """Loss and per-leaf gradients of the LM loss (``chunk`` > 0: the
    vocab-streaming one on the hidden states, as make_train_step's)."""
    from repro_torch import tree as tm
    from repro_torch.models import transformer as T
    from repro_torch.train import loss as L
    pairs = tm.leaves_with_path(params)
    leaves = [p.clone().requires_grad_() for _, p in pairs]
    p = tm.from_paths([(path, x) for (path, _), x in zip(pairs, leaves)])
    if chunk:
        head = p["embed"] if cfg.tie_embeddings else p["lm_head"]
        loss = L.chunked_cross_entropy_lm(
            T.forward(cfg, p, x, remat=remat, return_hidden=True), head,
            labels, chunk=chunk, head_is_embed=cfg.tie_embeddings)
    else:
        loss = L.cross_entropy_lm(T.forward(cfg, p, x, remat=remat), labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [(path, g) for (path, _), g in zip(pairs, grads)
                  if g is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", BACKBONE_ARCHS)
@pytest.mark.parametrize("remat,chunk", [(False, 0), (True, 0), (True, 200)])
def test_cuda_backbone_matches_cpu(arch, remat, chunk):
    """The dense backbone's four further architectures at the smoke size,
    the card against the CPU from the same parameters (fp32, no TF32):
    logits atol 1e-4, loss rtol 1e-5, gradients per leaf atol 1e-3 ·
    max|g| (the CPU tests' tolerances against JAX), with remat on and off
    and the vocab-streaming loss at a chunk (200) that does not divide
    the vocabulary (512); GELU (musicgen-large) and GeGLU (gemma-7b)."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    dev = _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    on_card = tm.tree_map(lambda x: x.to(dev), params)
    x, labels = _backbone_inputs(cfg, 2, 16, 1)
    with torch.no_grad():
        want = T.forward(cfg, params, x)
        got = T.forward(cfg, on_card, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    lc, gc = _loss_grads(cfg, params, x, labels, remat, chunk)
    lg, gg = _loss_grads(cfg, on_card, x.to(dev), labels.to(dev), remat,
                         chunk)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    assert [p for p, _ in gg] == [p for p, _ in gc]
    for (path, a), (_, b) in zip(gc, gg):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=1e-3 * a.abs().max().item() + 1e-12,
                                   msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", BACKBONE_ARCHS)
def test_cuda_backbone_prefill_decode_match_cpu(arch):
    """Prefill logits and cache, then step-by-step decode over drawn
    inputs (frame embeddings for musicgen-large), the card against the
    CPU (atol 1e-4; the cache 1e-4 · max(1, max|c|))."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    dev = _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.smoke_arch(arch)
    params = T.init_params(cfg, seed=0)
    on_card = tm.tree_map(lambda x: x.to(dev), params)
    x, _ = _backbone_inputs(cfg, 2, 12, 2)
    with torch.no_grad():
        lc, cc = T.prefill(cfg, params, x[:, :8], 16)
        lg, cg = T.prefill(cfg, on_card, x[:, :8].to(dev), 16)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        for key in cc:
            torch.testing.assert_close(
                cg[key].cpu(), cc[key], rtol=0,
                atol=1e-4 * max(1.0, cc[key].abs().max().item()), msg=key)
        for pos in range(8, 12):
            lc, cc = T.decode_step(cfg, params, cc, x[:, pos:pos + 1], pos)
            lg, cg = T.decode_step(cfg, on_card, cg,
                                   x[:, pos:pos + 1].to(dev), pos)
            torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
