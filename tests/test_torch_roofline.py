"""The port's roofline (``repro_torch.launch.roofline``) and the kernels'
cost model (``repro_torch.kernels.costs``), on the CPU.

  * Each ``Roofline`` term and ``engine_pass_time`` equals the JAX
    package's formula with the port's constants (the
    reference's module with its TPU constants swapped for the card's).
  * The products' time follows their dtype (bf16, TF32 where allowed,
    fp32 on the CUDA cores), and a collective group's link tier follows
    the span of its ranks (NVLink within an 8-GPU node, else InfiniBand).
  * The cost model gives PERF.md §6's bounds to the printed digit: rows
    3–18 at (4, 1,930,240, 256), the hierarchy's at (2, 2); rows 1–2 over
    the W = 4 qwen2-0.5b tree; rows 19–20 at the served models' shapes.
  * The meta branch of every engine wrapper charges its kernel and
    launches nothing.
  * ``scripts/roofline_report.py`` and ``scripts/gen_experiments_tables.py``
    print rows from a JSONL the port's dry run wrote at smoke size.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.comm.collectives import DryMesh  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import vrl_update as vu  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

FIELDS = dict(hlo_flops=3.1e14, hlo_bytes=2.2e11, coll_bytes=4.0e9,
              model_flops=5.0e16, chips=256, dci_bytes=1.5e9,
              coll_detail={"all-reduce": 4.0e9})


@pytest.fixture
def ref_on_h100(monkeypatch):
    """The reference's roofline module with the card's constants."""
    monkeypatch.setattr(jrl, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jrl, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_LINK_BW", tmesh.NVLINK_BW)
    monkeypatch.setattr(jrl, "DCI_LINK_BW", tmesh.IB_BW)
    return jrl


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_terms_are_the_reference_formulas(ref_on_h100, overlap, scale):
    """The FLOPs filed as bf16 products: the reference's compute term (its
    every product at the bf16 peak)."""
    kw = dict(FIELDS, hlo_flops=FIELDS["hlo_flops"] * scale)
    t = rl.Roofline(name="x", overlap=overlap,
                    flops_by_dtype={"bfloat16": kw["hlo_flops"]}, **kw)
    j = ref_on_h100.Roofline(name="x", overlap=overlap, **kw)
    for prop in ("t_compute", "t_memory", "t_collective", "t_coll_hidden",
                 "t_coll_exposed", "bottleneck", "useful_ratio"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("x", [0.0, 1.0, 6.995e9, 2.5e12])
def test_engine_pass_and_round_walltime(ref_on_h100, x):
    """``engine_pass_time``; the reference's ``round_walltime`` has no
    counterpart in the port (nothing reads it), so this holds only that
    the overlapped round's exposed collective, which ``Roofline`` prices,
    is the reference's."""
    assert rl.engine_pass_time(x) == ref_on_h100.engine_pass_time(x)
    assert rl.engine_pass_time(x) == 2 * x / 3.35e12
    kw = dict(FIELDS, hlo_bytes=x, overlap=True)
    t = rl.Roofline(name="x", flops_by_dtype={"bfloat16": FIELDS[
        "hlo_flops"]}, **kw)
    assert t.t_coll_exposed == ref_on_h100.Roofline(name="x",
                                                    **kw).t_coll_exposed


@pytest.mark.parametrize("tf32", [False, True])
def test_products_priced_by_dtype(tf32):
    r = rl.Roofline(name="x", hlo_flops=3e12, hlo_bytes=0.0, coll_bytes=0.0,
                    model_flops=0.0, chips=1, allow_tf32=tf32,
                    flops_by_dtype={"bfloat16": 1e12, "float32": 2e12},
                    kernel_flops=6.7e9)
    fp32 = 495e12 if tf32 else 67e12
    assert r.t_compute == 1e12 / 989e12 + 2e12 / fp32 + 6.7e9 / 67e12
    assert rl.peak_flops("float16") == 989e12
    assert rl.peak_flops("float64") == 67e12


@pytest.mark.parametrize("ranks,bw", [((0, 7), 450e9), ((3,), 450e9),
                                      ((8, 9, 15), 450e9), ((7, 8), 50e9),
                                      (tuple(range(16)), 50e9),
                                      ((0, 256), 50e9)])
def test_link_tier_follows_the_group_span(ranks, bw):
    assert rl.link_bw(ranks) == bw


@pytest.mark.parametrize("multi", [False, True])
def test_dry_mesh_group_ranks(multi):
    """The production grid, (16, 16) over ("data", "model") or (2, 16, 16)
    over ("pod", "data", "model"), as rank 0 sees it with no process
    group: its groups' ranks, row-major with the last axis fastest."""
    import torch.distributed as dist
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                   else ((16, 16), ("data", "model")))
    m = DryMesh(shape, axes)
    assert m.rank == 0 and m.coords == (0,) * len(shape)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        m.group()
    # the tensor axis's group: 16 adjacent ranks, two 8-GPU nodes
    assert m.group_ranks(("model",)) == tuple(range(16))
    assert m.group_ranks(("data",)) == tuple(range(0, 256, 16))
    if multi:
        assert m.group_ranks(("pod",)) == (0, 256)
        assert len(m.group_ranks(("pod", "data"))) == 32


@pytest.mark.parametrize("shards,tier", [(8, "nvlink"), (16, "ib")])
def test_analyze_prices_each_group(shards, tier):
    """Rank 0 of a (1, 2, S) grid: the shard group is S adjacent ranks (one
    node at 8, two at 16); the data group strides over S ranks (two
    nodes)."""
    mesh = DryMesh((1, 2, shards), ("pod", "data", "shard"))
    x = torch.empty(1000, device="meta")
    mesh.all_reduce(x, ("shard",), kind="state")
    mesh.all_reduce(x, ("data",), kind="state")
    y = mesh.all_gather(x, kind="forward", axes=("shard",))
    assert tuple(y.shape) == (shards, 1000) and y.device.type == "meta"
    counted = dryrun.Counted.__new__(dryrun.Counted)
    counted.flops, counted.flops_by_dtype, counted.bytes = 0, {}, 0
    counted.kernels = {}
    r = rl.analyze("x", counted, 0.0, 2 * shards, mesh=mesh)
    shard_b = 4000 + shards * 4000      # the all-reduce and the gather's
    assert r.coll_bytes == shard_b + 4000          # output bytes
    assert r.dci_bytes == 4000 + (shard_b if tier == "ib" else 0)
    assert r.coll_detail["all-gather/forward/shard"] == shards * 4000


# ------------------------------------------------------- the cost model
FULL, HIER = (4, 1_930_240, 256), (2, 2, 1_930_240, 256)
# PERF.md §6's bound column (ms, as printed) for rows 3-18
BOUNDS = {"fused_local_sgd": "9.440", "fused_local_momentum": "11.800",
          "fused_local_adam": "21.241", "fused_local_adam_sm3": "14.179",
          "fused_sync_vrl": "10.030", "fused_sync_bvr": "14.750",
          "fused_fold_overlap": "14.750", "fused_fold_overlap_bvr": "17.111",
          "fused_fold_overlap_avg": "10.030",
          "fused_fold_overlap_hier2": "10.030",
          "fused_sync_easgd": "7.080", "fused_ef_int8": "10.030",
          "fused_ef_topk": "10.030", "fused_ef_int8_grid": "10.620",
          "fused_ef_topk_grid": "10.620", "fused_hier_local_sgd": "10.620",
          "fused_hier_local_momentum": "15.341",
          "fused_hier_local_adam": "20.061",
          "fused_hier_local_adam_sm3": "12.999",
          "fused_sync_hier1": "10.620", "fused_sync_hier2": "6.490"}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_cost_model_gives_the_table_bounds(name):
    shape = HIER if ("hier" in name or name.endswith("_grid")) else FULL
    ms, by = costs.bound_ms(*costs.COSTS[name](*shape))
    assert f"{ms:.3f}" == BOUNDS[name]
    assert by == "bytes"


def _sizes(fn, pb, gb, db):
    """The element-size options ``fn`` (a ``COSTS`` entry) takes."""
    import inspect
    # the hierarchy's SM3 and top-k pass their options on
    target = {costs._hier_sm3: costs.adam_sm3_cost,
              costs._hier_topk: costs.hier_ef_cost}.get(fn, fn)
    params = inspect.signature(target).parameters
    return {k: v for k, v in (("pb", pb), ("gb", gb), ("db", db))
            if k in params}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_cost_model_bounds_by_operand_dtype(name):
    """The bounds charge each operand at its element size: fp32 sizes
    given keep §6's digits; bf16 parameters and gradients (fp32 Δ, then
    bf16 Δ) move fewer bytes.  At the main path's shape, fused_local_sgd
    moves 10 B an element instead of 16 (5.900 ms) and fused_sync_vrl
    12.5 B instead of 17 (7.375 ms)."""
    shape = HIER if ("hier" in name or name.endswith("_grid")) else FULL
    fn = costs.COSTS[name]
    ms32, _ = costs.bound_ms(*fn(*shape, **_sizes(fn, 4, 4, 4)))
    assert f"{ms32:.3f}" == BOUNDS[name]
    ms16, _ = costs.bound_ms(*fn(*shape, **_sizes(fn, 2, 2, 4)))
    ms16d, _ = costs.bound_ms(*fn(*shape, **_sizes(fn, 2, 2, 2)))
    assert ms16d <= ms16 < ms32
    want = {"fused_local_sgd": ("5.900", "4.720"),
            "fused_sync_vrl": ("7.375", "5.015")}.get(name)
    if want:
        assert (f"{ms16:.3f}", f"{ms16d:.3f}") == want


def test_cost_model_leaf_and_model_op_bounds():
    n = 4 * 494_032_768                  # the W = 4 qwen2-0.5b tree
    assert f"{costs.bound_ms(*costs.leaf_cost(n, n // 4, True))[0]:.3f}" \
        == "9.438"
    assert f"{costs.bound_ms(*costs.leaf_cost(n, n // 4, False))[0]:.3f}" \
        == "10.028"
    # flash_attention at qwen2's / granite's prefill, fp32 and bf16,
    # window None and 512; ssd_scan at mamba2-370m's layer 0
    want = {(14, 2, 4): ("0.182", "0.080"), (32, 8, 4): ("0.417", "0.182"),
            (14, 2, 2): ("0.046", "0.020"), (32, 8, 2): ("0.104", "0.046")}
    for (h, kvh, item), printed in want.items():
        for w, text in zip((None, 512), printed):
            nb, _, tc = costs.attention_cost(4, 2048, h, kvh, 64, w, item)
            assert f"{costs.bound_ms(nb, *tc)[0]:.3f}" == text, (h, w, item)
    for item, printed in ((4, "0.073"), (2, "0.048")):
        nb, _, tc = costs.ssd_cost(4, 2048, 32, 64, 128, 256, item)
        assert f"{costs.bound_ms(nb, *tc)[0]:.3f}" == printed


def test_main_path_defaults_unchanged_by_the_options():
    """The options a charge passes leave each default (the main path's
    operands) as it was."""
    assert costs.local_cost(*FULL) == costs.local_cost(
        *FULL, use_d=True, wd=1e-4, use_b=False)
    assert costs.adam_cost(*FULL) == costs.adam_cost(
        *FULL, use_d=True, use_b=True, m_bytes=4)
    assert costs.COSTS["fused_fold_overlap_bvr"](*FULL) == \
        costs.fold_cost(*FULL, 3, 0, 9)
    assert costs.COSTS["fused_fold_overlap_bvr"](*FULL, capture=True) == \
        costs.fold_cost(*FULL, 3, 1, 9)
    assert costs.hier_fold_cost(*HIER) == costs.hier_fold_cost(
        *HIER, capture=True)


def _m(*shape, dt=torch.float32):
    return torch.empty(shape, dtype=dt, device="meta")


def test_wrappers_charge_on_meta_and_launch_nothing():
    """Every engine kernel's wrapper on meta tensors: its operands checked,
    one charge of its name and shape, what the kernel returns, no
    launch."""
    vu.reset_launches()
    costs.reset_charges()
    w, r, c, pp, dd = 3, 8, 256, 2, 2
    p, g, d, b = (_m(w, r, c) for _ in range(4))
    x, s1, s2 = _m(r, c), _m(1, 1), _m(1, 2)
    gp = _m(pp, dd, r, c)
    pod = _m(pp, 1, r, c)
    assert vu.fused_local_sgd(p, g, d, lr=0.1, b=b) is p
    vu.fused_sync_vrl(p, x, d, s1)
    vu.fused_local_momentum(p, g, d, _m(w, r, c, dt=torch.bfloat16),
                            lr=0.1, beta=0.9)
    vu.fused_local_adam(p, g, d, _m(w, r, c), _m(w, r, c), s2, lr=0.1)
    out = vu.fused_local_adam_sm3(p, g, d, _m(w, r, c), _m(w, r, 1),
                                  _m(w, 2, c), s2, lr=0.1)
    assert out[3].shape == (w, 2, c) and out[3].device.type == "meta"
    vu.fused_sync_bvr(p, x, d, b, s1, beta=0.5)
    vu.fused_sync_easgd(p, x, _m(r, c), a=0.1, na=0.3)
    dec, e = vu.fused_ef_int8(p, x, _m(w, r, c))
    assert dec.shape == p.shape and dec is not p
    vu.fused_ef_topk(p, None, None, k=8, out=p)
    vu.fused_ef_int8_grid(gp, pod, _m(pp, dd, r, c))
    vu.fused_ef_topk_grid(gp, pod, _m(pp, dd, r, c), k=8)
    wscal = _m(w, 2)
    vu.fused_fold_overlap(p, x, _m(w, r, c), d, wscal)
    vu.fused_fold_overlap_bvr(p, x, _m(w, r, c), d, b, wscal, beta=0.5,
                              capture=False)
    vu.fused_fold_overlap_avg(p, x, _m(w, r, c), wscal)
    vu.fused_hier_local_sgd(gp, gp, gp, pod, lr=0.1)
    vu.fused_sync_hier1(gp, pod, gp, s1)
    vu.fused_sync_hier2(gp, x, pod, s1)
    vu.fused_fold_overlap_hier2(gp, x, pod, pod, _m(pp, 2))
    vu.fused_hier_local_momentum(gp, gp, gp, pod, gp, lr=0.1, beta=0.9)
    vu.fused_hier_local_adam(gp, gp, gp, pod, gp, gp, s2, lr=0.1)
    vu.fused_hier_local_adam_sm3(gp, gp, gp, pod, gp, _m(pp, dd, r, 1),
                                 _m(pp, dd, 1, c), s2, lr=0.1)
    new = vu.vrl_local_update(_m(5, 7), _m(5, 7), _m(5, 7), lr=0.1)
    assert new.shape == (5, 7)
    vu.vrl_sync_update(_m(4, 5, 7, dt=torch.bfloat16), _m(5, 7),
                       _m(4, 5, 7), inv_kg=2.0)
    assert not any(vu.LAUNCHES.values())
    assert set(costs.CHARGES) == set(vu.LAUNCHES)
    assert all(v["calls"] == 1 for v in costs.CHARGES.values())
    n = w * r * c
    # the charges read the call: local sgd with Δ and B, bf16 momentum,
    # the bvr fold without capture, the leaf pair's dtypes
    assert costs.CHARGES["fused_local_sgd"]["bytes"] == 4 * n * 5
    assert costs.CHARGES["fused_local_momentum"]["bytes"] == \
        4 * n * 4 + 2 * 2 * n
    assert costs.CHARGES["fused_fold_overlap_bvr"]["bytes"] == \
        costs.fold_cost(w, r, c, 3, 0, 9)[0]
    assert costs.CHARGES["vrl_sync_update"]["bytes"] == \
        costs.leaf_cost(140, 35, False, (2, 4, 4))[0]
    assert costs.CHARGES["fused_ef_int8_grid"]["shapes"] == {
        f"{pp}x{dd}x{r}x{c}": 1}
    # bf16 parameters and gradients, a bf16 Δ: charged at their sizes
    costs.reset_charges()
    h = torch.bfloat16
    vu.fused_local_sgd(_m(w, r, c, dt=h), _m(w, r, c, dt=h),
                       _m(w, r, c, dt=h), lr=0.1)
    vu.fused_sync_vrl(_m(w, r, c, dt=h), _m(r, c, dt=h), _m(w, r, c),
                      s1)
    assert costs.CHARGES["fused_local_sgd"]["bytes"] == 2 * n * 4
    assert costs.CHARGES["fused_sync_vrl"]["bytes"] == \
        2 * 2 * n + 2 * 4 * n + 2 * r * c + 4


def test_wrappers_check_meta_operands():
    # bf16 parameters take an x̂ of their dtype, fp16 is no kernel's
    with pytest.raises(TypeError):
        vu.fused_sync_vrl(_m(2, 8, 256, dt=torch.bfloat16), _m(8, 256),
                          _m(2, 8, 256), _m(1, 1))
    with pytest.raises(TypeError):
        vu.fused_local_sgd(_m(2, 8, 256, dt=torch.float16),
                           _m(2, 8, 256), None, lr=0.1)
    with pytest.raises(ValueError):
        vu.fused_sync_vrl(_m(2, 8, 256), _m(4, 256), _m(2, 8, 256),
                          _m(1, 1))
    e = _m(2, 8, 256)
    with pytest.raises(ValueError):
        vu.fused_ef_int8(_m(2, 8, 256), None, e, out=e)
    # rows wider than the EF kernel takes: refused on meta as on the card,
    # before any charge
    costs.reset_charges()
    with pytest.raises(ValueError, match="lanes"):
        vu.fused_ef_int8(_m(2, 8, 2048), None, None)
    with pytest.raises(ValueError, match="lanes"):
        vu.fused_ef_topk_grid(_m(2, 2, 8, 2048), None, None, k=8)
    assert costs.CHARGES == {}


# ------------------------------------------------------------- the scripts
@pytest.fixture(scope="module")
def rows_file(tmp_path_factory):
    """Smoke-size rows of the port's dry run: qwen2-0.5b's, mamba2-370m's
    and kimi-k2's train (local, sync), prefill and decode; kimi-k2 trains
    with a worker over its fsdp ranks and serves on its 2D-sharded grid;
    a membership round is refused (the dry run holds no mask to read)."""
    path = tmp_path_factory.mktemp("rows") / "dryrun_torch.jsonl"
    with open(path, "w") as f:
        for arch in ("qwen2-0.5b", "mamba2-370m", "kimi-k2-1t-a32b"):
            sm = registry.smoke_arch(arch)
            over = {k.name: getattr(sm, k.name)
                    for k in dataclasses.fields(sm)}
            for fn, shape in (("local", "train_4k"), ("sync", "train_4k"),
                              ("prefill", "prefill_32k"),
                              ("decode", "decode_32k"),
                              ("round", "train_4k")):
                kind = registry.get_shape(shape).kind
                vrl = (base.VRLConfig(membership=True) if fn == "round"
                       else None)
                if fn == "round" and arch != "mamba2-370m":
                    continue
                try:
                    r = dryrun.lower_one(
                        arch, shape, multi_pod=False, fn_kind=fn,
                        cfg_override=over, verbose=False, vrl_cfg=vrl,
                        shape_override=base.InputShape(shape, 32, 16, kind))
                except NotImplementedError as e:
                    r = dryrun.DryrunResult(arch, shape, "single", fn, False,
                                            0.0, -1, None, error=str(e))
                f.write(json.dumps(r.to_json()) + "\n")
    return str(path)


def test_roofline_report_prints_counted_rows(rows_file, capsys):
    from repro_torch.scripts import roofline_report
    out = roofline_report.main([rows_file])
    text = capsys.readouterr().out
    assert set(out) == {(a, s, "single") for a in ("qwen2-0.5b",
                                                   "mamba2-370m",
                                                   "kimi-k2-1t-a32b")
                        for s in ("train_4k", "prefill_32k", "decode_32k")}
    lines = [x for x in text.splitlines() if x.startswith("roofline/")]
    assert len(lines) == 9 and all("calib=counted" in x for x in lines)
    assert "roofline/qwen2-0.5b/train_4k/single," in text


def test_experiments_tables_print_rows(rows_file, capsys):
    from repro_torch.scripts import gen_experiments_tables
    gen_experiments_tables.main([rows_file])
    text = capsys.readouterr().out
    assert "| qwen2-0.5b | train_4k | OK |" in text
    assert "| kimi-k2-1t-a32b | train_4k | OK |" in text
    assert "| kimi-k2-1t-a32b | decode_32k | OK |" in text
    assert "**memory**" in text or "**compute**" in text
    assert "mamba2-370m/train_4k/single/round: membership" in text
