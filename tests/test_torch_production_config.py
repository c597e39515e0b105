"""The production layout's configs and partition specs, field for field
against the JAX package's: ``INPUT_SHAPES``, ``pad_for_mesh``,
``registry.mesh_roles`` (``MeshConfig``'s fields and sizes) /
``padded_arch`` for the ten architectures × multi_pod × serving, and
``sharding.specs`` (``axis_rules``, ``partition_specs`` leaf for leaf as
tuples, ``worker_stacked_spec``, ``batch_spec``), plus the H100 constants
of ``launch.mesh``."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

ARCHS = jreg.list_archs()
ROLES = [(m, s) for m in (False, True) for s in (False, True)]


def test_archs_are_the_reference_pool():
    assert treg.list_archs() == ARCHS
    assert treg._FSDP_ARCHS == jreg._FSDP_ARCHS
    assert treg._FSDP_SERVE_ARCHS == jreg._FSDP_SERVE_ARCHS


def test_input_shapes():
    assert {k: dataclasses.asdict(v) for k, v in
            tbase.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    for k in jbase.INPUT_SHAPES:
        assert dataclasses.asdict(treg.get_shape(k)) == \
            dataclasses.asdict(jreg.get_shape(k))
    with pytest.raises(KeyError):
        treg.get_shape("train_8k")


@pytest.mark.parametrize("tensor", [1, 3, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_pad_for_mesh(arch, tensor):
    t = tbase.pad_for_mesh(treg.get_arch(arch), tensor)
    j = jbase.pad_for_mesh(jreg.get_arch(arch), tensor)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("multi,serving", ROLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_roles_and_padded_arch(arch, multi, serving):
    t = treg.mesh_roles(arch, multi_pod=multi, serving=serving)
    j = jreg.mesh_roles(arch, multi_pod=multi, serving=serving)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("num_workers", "tensor_size", "fsdp_size"):
        assert getattr(t, prop) == getattr(j, prop), prop
    tc, jc = treg.padded_arch(arch, t), jreg.padded_arch(arch, j)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()


def _tuple(spec):
    assert isinstance(spec, P)
    return tuple(spec)


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): _tuple(s)
            for path, s in flat}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_leaf_for_leaf(arch, multi):
    jm = jreg.mesh_roles(arch, multi_pod=multi)
    tm = treg.mesh_roles(arch, multi_pod=multi)
    jc, tc = jreg.padded_arch(arch, jm), treg.padded_arch(arch, tm)
    assert tspecs.axis_rules(tc, tm) == jspecs.axis_rules(jc, jm)
    want = _jax_specs(jspecs.partition_specs(jtf.model_defs(jc), jc, jm))
    got = dict(tree_mod.leaves_with_path(
        tspecs.partition_specs(ttf.model_defs(tc), tc, tm)))
    got = {k.replace(".", "/"): v for k, v in got.items()}
    assert got == want


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "kimi-k2-1t-a32b"])
def test_worker_stacked_and_batch_specs(arch, multi):
    jm = jreg.mesh_roles(arch, multi_pod=multi)
    tm = treg.mesh_roles(arch, multi_pod=multi)
    for spec in [(None, "model"), ("model", None, None), ()]:
        assert tspecs.worker_stacked_spec(spec, tm) == \
            _tuple(jspecs.worker_stacked_spec(P(*spec), jm))
    for ws in (False, True):
        for extra in (0, 1, 2):
            assert tspecs.batch_spec(tm, worker_stacked=ws,
                                     extra_dims=extra) == \
                _tuple(jspecs.batch_spec(jm, worker_stacked=ws,
                                         extra_dims=extra))


def test_h100_constants():
    """The NVIDIA H100 SXM5 80GB (700 W) data sheet's figures, and the
    kernels' cost model reads the same ones."""
    from repro_torch.kernels import costs
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 == costs.PEAK_FLOPS_BF16
    assert tmesh.PEAK_FLOPS_TF32 == 495e12 == costs.PEAK_FLOPS_TF32
    assert tmesh.PEAK_FLOPS_FP32 == 67e12 == costs.PEAK_FLOPS_FP32
    assert tmesh.HBM_BW == 3.35e12 == costs.HBM_BW
    assert tmesh.HBM_PER_CHIP == 80e9
    assert (tmesh.CHIPS_PER_POD, tmesh.GPUS_PER_NODE) == (256, 8)
    assert (tmesh.NVLINK_BW, tmesh.IB_BW) == (450e9, 50e9)
