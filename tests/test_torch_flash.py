"""PyTorch port, the attention op (``kernels.mha_flash`` and
``kernels/flash_attention.flash_attention``) vs the JAX package's Pallas
kernel, run as its own tests run it on the CPU (interpret mode).

On the CPU the port's wrapper runs its plain version
(``flash_attention_ref``: the Pallas kernel's function in one fp32
softmax), so these tests hold that function, and the wrapper's layout
steps (GQA, padding, head-major), against the reference.  The CUDA kernel
is held to the same plain version on the card (tests/test_torch_cuda.py).

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (the reference's own,
tests/test_kernel_properties.py): the online softmax and a one-pass
softmax sum in other orders.  bf16: one bf16 ulp of the output beyond
that fp32 tolerance — both compute in fp32 within it and round once, so
they may land on neighbouring bf16 values; and an output near zero, a
cancelling sum of p·v, carries the fp32 tolerance's absolute error, which
there is more than a bf16 ulp.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as j_flash,
)
from repro.kernels.ref import flash_attention_ref as j_ref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), for bf16 values in fp32."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), np.maximum(e, -125) - 8)


def assert_close(got: torch.Tensor, want, dtype: str):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        bad = np.abs(got - want) > ulp + ATOL + RTOL * np.abs(want)
        assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# --------------------------------------------- (BH, S, D): the kernel's API
@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (4, 128, 128),
                                    (1, 512, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_shapes_dtypes(bh, s, d, dtype):
    """tests/test_kernels.py's sweep: the port against interpret Pallas."""
    jd, td = DTYPES[dtype]
    q, k, v = _arrays(bh * s + d, *[(bh, s, d)] * 3)
    blk = 128 if s >= 128 else s
    want = j_flash(*(_jax(x, jd) for x in (q, k, v)), block_q=blk,
                   block_k=blk, interpret=True)
    got = tfa.flash_attention(*(_torch(x, td) for x in (q, k, v)),
                              block_q=blk, block_k=blk)
    assert got.dtype == td
    assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 1, 16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window(window, causal):
    q, k, v = _arrays(5, *[(2, 256, 64)] * 3)
    want = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   window=window, block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window, block_q=64,
                              block_k=64)
    assert_close(got, want, "f32")


def test_flash_attention_block_shape_independence():
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, *[(2, 256, 64)] * 3))
    o1 = tfa.flash_attention(q, k, v, block_q=64, block_k=128)
    o2 = tfa.flash_attention(q, k, v, block_q=128, block_k=64)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=0, atol=2e-5)


def test_flash_attention_keeps_the_reference_assert():
    q = torch.zeros(1, 100, 16)
    with pytest.raises(AssertionError):
        tfa.flash_attention(q, q, q, block_q=64, block_k=64)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None), (False, 8)])
def test_plain_version_matches_reference_oracle(causal, window):
    """In fp32 the plain version is ``repro.kernels.ref``'s oracle."""
    q, k, v = _arrays(7, *[(3, 96, 32)] * 3)
    want = j_ref(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                 window=window)
    got = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=causal, window=window)
    assert_close(got, want, "f32")


def test_plain_version_is_the_kernels_function_in_bf16():
    """For bf16 the plain version follows the Pallas kernel (fp32 inside),
    not the oracle, which multiplies in bf16: against the kernel it is
    within the bf16 bound everywhere, where the oracle parts from it by
    more."""
    q, k, v = _arrays(8, *[(2, 128, 64)] * 3)
    jq, jk, jv = (_jax(x, jnp.bfloat16) for x in (q, k, v))
    kernel = j_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention_ref(*(_torch(x, torch.bfloat16)
                                    for x in (q, k, v)))
    assert_close(got, kernel, "bf16")
    oracle = np.asarray(j_ref(jq, jk, jv).astype(jnp.float32))
    kern = np.asarray(kernel.astype(jnp.float32))
    assert (np.abs(oracle - kern) > bf16_ulp(np.abs(kern)) + ATOL
            + RTOL * np.abs(kern)).any()


# ---------------------------------------------- (B, S, H, D): mha_flash
MHA_CASES = [
    # b, s, h, kvh, d, causal, window, block_q, block_k
    (1, 1, 2, 1, 16, True, None, 32, 32),
    (2, 100, 4, 2, 32, True, None, 32, 32),
    (1, 70, 3, 3, 16, True, 16, 32, 32),
    (2, 96, 6, 2, 64, True, 16, 32, 64),
    (1, 257, 2, 1, 16, True, 64, 128, 128),
    (1, 45, 7, 1, 32, True, None, 16, 32),
    (2, 33, 4, 4, 16, False, 8, 32, 32),
    (1, 64, 2, 2, 128, True, None, 64, 64),
]


@pytest.mark.parametrize("case", MHA_CASES,
                         ids=[f"b{c[0]}s{c[1]}h{c[2]}kv{c[3]}d{c[4]}"
                              f"{'c' if c[5] else 'n'}w{c[6]}" for c in
                              MHA_CASES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mha_flash_matches_reference(case, dtype):
    """Ragged S (padded to the block), GQA (KV heads read per group),
    windows, causal on and off: the port's op against the reference op in
    interpret mode."""
    b, s, h, kvh, d, causal, window, bq, bk = case
    jd, td = DTYPES[dtype]
    q, k, v = _arrays(s * h + d, (b, s, h, d), (b, s, kvh, d),
                      (b, s, kvh, d))
    want = jops.mha_flash(*(_jax(x, jd) for x in (q, k, v)), causal=causal,
                          window=window, block_q=bq, block_k=bk,
                          interpret=True)
    got = tkernels.mha_flash(*(_torch(x, td) for x in (q, k, v)),
                             causal=causal, window=window, block_q=bq,
                             block_k=bk)
    assert got.shape == (b, s, h, d) and got.dtype == td
    assert_close(got, want, dtype)


@pytest.mark.parametrize("s", [40, 100])
def test_mha_flash_non_causal_attends_the_padding(s):
    """With causal=False and S not a multiple of the block the reference
    attends to the padded zero keys (it has no length mask): the port
    keeps that function, which is not plain attention over the S keys."""
    q, k, v = _arrays(11, (1, s, 2, 16), (1, s, 1, 16), (1, s, 1, 16))
    want = jops.mha_flash(*(jnp.asarray(x) for x in (q, k, v)),
                          causal=False, block_q=32, block_k=32,
                          interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tops.mha_flash(tq, tk, tv, causal=False, block_q=32, block_k=32)
    assert_close(got, want, "f32")
    unpadded = tops.mha_flash(tq, tk, tv, causal=False, block_q=s,
                              block_k=s)
    assert (got - unpadded).abs().max() > 1e-3


def test_mha_flash_gqa_is_repeat():
    """Each KV head serves H / KVH consecutive query heads (jnp.repeat)."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(
        12, (2, 48, 6, 32), (2, 48, 2, 32), (2, 48, 2, 32)))
    got = tops.mha_flash(q, k, v, block_q=16, block_k=16)
    want = tops.mha_flash(q, k.repeat_interleave(3, dim=2),
                          v.repeat_interleave(3, dim=2), block_q=16,
                          block_k=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kshape", [(1, 16, 3, 16), (1, 8, 2, 16),
                                    (1, 16, 2, 32)])
def test_mha_flash_refuses_mismatched_heads(kshape):
    q = torch.zeros(1, 16, 4, 16)
    k = torch.zeros(kshape)
    with pytest.raises(ValueError):
        tops.mha_flash(q, k, k, block_q=16, block_k=16)


def test_cpu_calls_are_not_launches():
    n0 = tfa.LAUNCHES["flash_attention"]
    q = torch.zeros(1, 16, 2, 16)
    tops.mha_flash(q, q, q, block_q=16, block_k=16)
    tfa.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0], block_q=16,
                        block_k=16)
    assert tfa.LAUNCHES["flash_attention"] == n0


def test_kernel_path_refuses_cpu_tensors():
    """The kernel's entry takes CUDA tensors only: a CPU tensor never
    reaches it from the wrappers, and called directly it raises."""
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError):
        tfa.attend_bshd(q, q, q, causal=True, window=None, s_pad=16)
