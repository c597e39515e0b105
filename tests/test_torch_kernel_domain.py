"""The shape domain of the port's two model kernels, on the CPU: the
host-side predicates that the wrappers check before a launch.

``flash_attention.head_dim_supported`` takes every head dim 1 ≤ D ≤ 256,
``ssd_scan.shape_supported`` every (P, N) with P ≤ 128 and N ≤ 256 whose
largest block fits 227 KB of shared memory at the chunk; both accept every
head dim and every (ssm_head_dim, ssm_state) of the reference's registry
(``repro.configs.registry``), and past their limits the wrappers' checks
raise with a message that names the limit.  The kernels themselves run only
on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

ARCHS = sorted(registry.ARCHS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_predicates_take_every_registry_config(arch):
    cfg = registry.get_arch(arch)
    if cfg.num_heads:
        assert fa.head_dim_supported(cfg.head_dim), cfg.head_dim
        fa.check_head_dim("flash_attention", cfg.head_dim)
    if cfg.ssm_state:
        assert ss.shape_supported(cfg.ssm_head_dim, cfg.ssm_state)
        ss.check_shape("ssd_scan", cfg.ssm_head_dim, cfg.ssm_state, 256)


def test_registry_holds_the_widths_the_kernels_were_widened_for():
    dims = {registry.get_arch(a).head_dim for a in ARCHS
            if registry.get_arch(a).num_heads}
    assert {80, 112, 256} <= dims
    assert fa.INSTANCE_DIMS == (16, 32, 64, 80, 96, 112, 128, 256)


@pytest.mark.parametrize("d", [1, 8, 36, 40, 72, 100, 200, 255, 256])
def test_head_dims_up_to_256_are_taken(d):
    assert fa.head_dim_supported(d)
    fa.check_head_dim("flash_attention", d)


@pytest.mark.parametrize("d", [0, 257, 512])
def test_head_dims_past_the_limit_are_refused(d):
    assert not fa.head_dim_supported(d)
    with pytest.raises(ValueError, match=r"1 ≤ D ≤ 256 .*shared memory"):
        fa.check_head_dim("flash_attention", d)


@pytest.mark.parametrize("p,n,chunk", [(1, 1, 1), (16, 8, 16), (64, 128, 4096),
                                       (64, 16, 256), (128, 256, 256),
                                       (80, 200, 256), (128, 256, 2474)])
def test_ssd_shapes_in_the_domain_are_taken(p, n, chunk):
    assert ss.shape_supported(p, n, chunk)
    ss.check_shape("ssd_scan", p, n, chunk)


@pytest.mark.parametrize("p,n", [(0, 16), (129, 16), (64, 0), (64, 257)])
def test_ssd_shapes_past_the_limits_are_refused(p, n):
    assert not ss.shape_supported(p, n)
    with pytest.raises(ValueError, match="P ≤ 128 and N ≤ 256"):
        ss.check_shape("ssd_scan", p, n, 256)


def test_ssd_state_past_shared_memory_names_the_widest_n():
    """N = 256 fits chunks up to 2474 steps; at 4096 the message gives the
    bytes asked and the widest N that fits there."""
    assert not ss.shape_supported(64, 256, 2475)
    need = ss.smem_bytes(64, 256, 4096)
    assert need > ss.SMEM_LIMIT
    widest = ss.widest_state(64, 4096)
    assert 0 < widest < 256 and ss.shape_supported(64, widest, 4096)
    assert not ss.shape_supported(64, widest + 16, 4096)
    with pytest.raises(ValueError, match=f"needs {need} bytes.*widest N "
                                         f"that fits at this chunk is "
                                         f"{widest}"):
        ss.check_shape("ssd_scan", 64, 256, 4096)


def test_ssd_smem_fp32_is_the_largest():
    """bf16 operands never ask for more than fp32 (the predicate's count);
    at N = 256 the bf16 C rows make the output stage smaller."""
    for p, n in ((64, 256), (128, 128), (16, 64)):
        full = ss.smem_bytes(p, n, 256)
        for xs, bcs in ((2, 2), (2, 4), (4, 2)):
            assert ss.smem_bytes(p, n, 256, xs, bcs) <= full
    assert ss.smem_bytes(64, 256, 256, 2, 2) < ss.smem_bytes(64, 256, 256)
