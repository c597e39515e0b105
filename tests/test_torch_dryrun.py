"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

  * ``engine_mem`` for the ten architectures at the defaults, at
    ``--shards 16``, at the CI gate's ``--shards 8 --moment-dtype
    bfloat16``, at ``--sm3 --moment-dtype bfloat16 --shards 16``, and with
    ``--clients 64`` on qwen2-0.5b: every (W, R, C) buffer equal in shape,
    dtype, bytes and per-device bytes; ``reduction`` and ``devices_used``
    equal; the totals equal up to the reference's 0-d scalar leaves (the
    step counters and Adam's count), which the port keeps on the host.
  * The collective bytes that ``lower_one`` counts for qwen2-0.5b
    ``train_4k`` equal to the reference's HLO parse: the sync on the
    single mesh, at ``--shards 16``, hier_vrl_sgd's sync1 and sync2 on
    the multi mesh (sync2 all on the inter-node tier, as the reference
    puts it all on DCI), and ``--compress int8``'s wire bytes.
  * The meta count of a smoke model's local step equals
    ``FlopCounterMode`` on the same step run on the CPU, at fp32 and at
    the dry run's bf16 parameters (then every product is counted bf16).
  * The dry mesh's counts equal those of gloo ranks (``torch_dryrun_ranks``)
    on a flat (1 x 2) grid, a hierarchical one and a row-sharded one (data
    2 x shard 2).
  * ``engine_mem``'s ``port`` figure: the state the port trains, which is
    the reference's layout (bf16 params, the FSDP archs' bf16 Δ).
  * The CLI: the CI gate's exit codes on the reference's layout (the
    port's), the reference's keys on a row, kimi-k2's FSDP layout in
    training and its 2D-sharded serving layout on the 256-rank grid.
  * ``input_specs``, ``cache_specs``, ``state_specs`` and
    ``batch_sharding_spec`` against the reference's, entry for entry;
    rank 0's blocks of the weights and of each input, read from them.

The JAX side runs in one subprocess, started with the module (importing
``repro.launch.dryrun`` sets ``XLA_FLAGS``), beside the port's side.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as tmp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import torch_dryrun_ranks as DR  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = registry.list_archs()
MEM = {"default": {}, "shards16": {"shards": 16},
       "gate": {"shards": 8, "moment_dtype": "bfloat16"},
       "sm3": {"sm3": True, "moment_dtype": "bfloat16", "shards": 16}}
MEM_CASES = [(a, t) for a in ARCHS for t in MEM] + [("qwen2-0.5b",
                                                     "clients64")]
# qwen2-0.5b train_4k lowerings: name -> lower_one keywords (both packages)
LOWER = {"sync": dict(fn_kind="sync", multi_pod=False),
         "sync_shards16": dict(fn_kind="sync", multi_pod=False, shards=16),
         "sync1": dict(fn_kind="sync1", multi_pod=True,
                       algorithm="hier_vrl_sgd"),
         "sync2": dict(fn_kind="sync2", multi_pod=True,
                       algorithm="hier_vrl_sgd"),
         "sync_int8": dict(fn_kind="sync", multi_pod=False,
                           compress="int8")}
SCALARS = 16            # at most this many bytes of 0-d leaves
SPEC_ARCHS = ("qwen2-0.5b", "mamba2-370m", "hymba-1.5b",
              "phi3.5-moe-42b-a6.6b", "musicgen-large", "kimi-k2-1t-a32b")
# VRLConfig fields of state_specs' cases (the compressor as text)
SPEC_VRL = {"vrl_sgd": {}, "adam_int8": dict(inner_optimizer="adam",
                                              compress="int8"),
            "easgd": dict(algorithm="easgd", inner_optimizer="momentum",
                          momentum=0.9),
            "bvr": dict(algorithm="bvr_l_sgd"),
            "ssgd_topk": dict(algorithm="ssgd", compress="topk:8:noef")}

REF_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import PartitionSpec as P
from repro.comm import compressors as cm
from repro.configs import registry
from repro.configs.base import VRLConfig
from repro.launch import dryrun as d
mem, lower = json.loads(sys.argv[1]), json.loads(sys.argv[2])
archs, vrl = json.loads(sys.argv[3]), json.loads(sys.argv[4])

def js(x):
    if isinstance(x, P):
        return ["P", [list(e) if isinstance(e, tuple) else e for e in x]]
    if isinstance(x, jax.ShapeDtypeStruct):
        return ["S", list(x.shape)]
    if isinstance(x, dict):
        return {str(k): js(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: js(getattr(x, f)) for f in x._fields}
    if isinstance(x, tuple) and not x:
        return None
    return x

specs = {}
for arch in archs:
    for multi in (False, True):
        for serving in (False, True):
            m = registry.mesh_roles(arch, multi_pod=multi, serving=serving)
            c = registry.padded_arch(arch, m)
            key = arch + ("/multi" if multi else "/single") + (
                "/serve" if serving else "/train")
            specs[key + "/cache"] = js(d.cache_specs(c, m, 128, 32768))
            specs[key + "/cache1"] = js(d.cache_specs(c, m, 1, 7))
            for b in (1, 16, 256):
                for ws in (False, True):
                    specs[key + "/batch/%d/%d" % (b, ws)] = js(
                        d.batch_sharding_spec(m, b, 1, worker_stacked=ws))
            if not serving:
                for tag, kw in vrl.items():
                    kw = dict(kw)
                    if "compress" in kw:
                        kw["compress"] = cm.parse_compressor(kw["compress"])
                    specs[key + "/state/" + tag] = js(
                        d.state_specs(c, m, VRLConfig(**kw)))
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k"):
                if (registry.get_shape(shape).kind == "train") == serving:
                    continue
                specs[key + "/inputs/" + shape] = js(
                    d.input_specs(arch, shape, m))
out = {"mem": {}, "lower": {}, "specs": specs}
for arch in registry.list_archs():
    for tag, kw in mem.items():
        out["mem"][arch + "/" + tag] = d.engine_mem(arch, verbose=False, **kw)
out["mem"]["qwen2-0.5b/clients64"] = d.engine_mem(
    "qwen2-0.5b", clients=64, verbose=False)
for key, kw in lower.items():
    out["lower"][key] = d.lower_one("qwen2-0.5b", "train_4k", verbose=False,
                                    **kw).to_json()
out["model_flops"] = {}
for arch in sorted(registry._FSDP_ARCHS):
    for multi in (False, True):
        m = registry.mesh_roles(arch, multi_pod=multi)
        out["model_flops"][arch + ("/multi" if multi else "/single")] = \
            d._model_flops_train(registry.padded_arch(arch, m),
                                 registry.get_shape("train_4k"))
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The JAX package's artifacts, from one subprocess started at the
    module's first test; ``ref()`` waits for them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(MEM),
         json.dumps(LOWER), json.dumps(SPEC_ARCHS), json.dumps(SPEC_VRL)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    box = {}

    def get():
        if "out" not in box:
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0, se[-4000:]
            line = next(x for x in so.splitlines() if x.startswith("REF "))
            box["out"] = json.loads(line[4:])
        return box["out"]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _start(ref):
    """Starts the JAX subprocess before any test of the module runs."""
    yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- engine_mem
def _port_mem(arch, tag):
    if tag == "clients64":
        return dryrun.engine_mem(arch, clients=64, verbose=False)
    return dryrun.engine_mem(arch, verbose=False, **MEM[tag])


@pytest.mark.parametrize("arch,tag", MEM_CASES)
def test_engine_mem_matches_reference(ref, arch, tag):
    r = ref()["mem"][f"{arch}/{tag}"]
    p = _port_mem(arch, tag)
    # the reference's 0-d leaves the port keeps on the host (step counters,
    # Adam's count): named, and at most SCALARS bytes
    host = {k: b for k, b in r["buffers"].items() if k not in p["buffers"]}
    assert set(host) <= {"step", "last_sync", "inner/count"}, host
    assert all(b["shape"] == [] for b in host.values()), host
    extra = sum(b["bytes"] for b in host.values())
    extra_dev = sum(b["per_device_bytes"] for b in host.values())
    assert extra <= SCALARS
    assert set(p["buffers"]) <= set(r["buffers"])
    for key, b in p["buffers"].items():
        assert b == r["buffers"][key], key
    for k in ("arch", "algorithm", "inner", "workers", "shards",
              "moment_dtype", "sm3", "delta_dtype", "devices_used",
              "reduction", "chips_per_pod"):
        assert p[k] == r[k], k
    assert p["total_bytes"] == r["total_bytes"] - extra
    assert p["per_device_bytes"] == r["per_device_bytes"] - extra_dev
    assert p["baseline_per_device_bytes"] == \
        r["baseline_per_device_bytes"] - extra_dev
    assert p["hbm_per_chip"] == mesh_mod.HBM_PER_CHIP == 80 * 10**9
    assert p["fits_pod"] == (p["devices_used"] <= 256
                             and p["per_device_bytes"] <= 80 * 10**9)
    assert p["t_engine_pass"] == 2.0 * p["per_device_bytes"] / 3.35e12
    # the state the port trains is the reference's layout: bf16 params,
    # the reference's Δ dtype, every figure equal to the top-level ones
    port = p["port"]
    assert p["buffers"]["params"]["dtype"] == "bfloat16"
    assert (port["param_dtype"], port["delta_dtype"]) == ("bfloat16",
                                                          r["delta_dtype"])
    assert port["total_bytes"] == p["total_bytes"]
    assert port["per_device_bytes"] == p["per_device_bytes"]
    assert port["fits_pod"] == p["fits_pod"] == (
        p["devices_used"] <= 256 and port["per_device_bytes"] <= 80 * 10**9)
    assert port["t_engine_pass"] == p["t_engine_pass"]
    if tag == "clients64":
        assert p["client_store_bytes"] == r["client_store_bytes"] - extra


# ---------------------------------------------------- collective bytes
@pytest.fixture(scope="module")
def lowered():
    return {k: dryrun.lower_one("qwen2-0.5b", "train_4k", verbose=False,
                                **kw) for k, kw in LOWER.items()}


@pytest.mark.parametrize("key", list(LOWER))
def test_collective_bytes_match_reference_hlo(ref, lowered, key):
    r = ref()["lower"][key]
    p = lowered[key].to_json()
    assert p["ok"] and r["ok"]
    assert p["coll_bytes"] == r["coll_bytes"], (p["coll_detail"],
                                                r["coll_detail"])
    if key == "sync2":
        # the cross-pod all-reduce: all on the slow tier in both packages
        assert r["dci_bytes"] == r["coll_bytes"]
        assert p["dci_bytes"] == p["coll_bytes"] > 0
    assert p.get("comp_bytes", 0) == r.get("comp_bytes", 0)
    assert p.get("compressor", "") == r.get("compressor", "")
    assert p["kernels"] == {"sync": {"fused_sync_vrl": 1},
                            "sync_shards16": {"fused_sync_vrl": 1},
                            "sync1": {"fused_sync_hier1": 1},
                            "sync2": {"fused_sync_hier2": 1},
                            "sync_int8": {"fused_ef_int8": 1,
                                          "fused_sync_vrl": 1}}[key]
    # one model-state all-reduce on rank 0's group
    state = p["collectives"]["state"]
    assert sum(v["calls"] for v in state.values()) == 1, state


def test_sync_collective_is_the_padded_flat_buffer(lowered):
    """1,998,585,856 B: padded qwen2-0.5b's 1,951,744 rows of 256 fp32
    lanes (14 heads padded to 16 for the 16-wide tensor axis), one worker
    a rank; at 16 row shards a rank's 1/16 of the rows padded to blocks."""
    assert lowered["sync"].roofline.coll_bytes == 1_951_744 * 256 * 4
    assert lowered["sync_shards16"].roofline.coll_bytes == 125_829_120


# ----------------------------------------------------------------- FLOPs
SMOKE_ARCHS = ("qwen2-0.5b", "mamba2-370m", "hymba-1.5b",
               "phi3.5-moe-42b-a6.6b", "musicgen-large")


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_meta_flops_equal_cpu_flop_counter(arch, pdt):
    """The smoke model's local step (W = 2, batch 4 x 32) counted on meta
    tensors equals FlopCounterMode on the same step run on the CPU, and
    charges the kernel the CPU run would launch on the card; at the dry
    run's bf16 parameters (its default, the reference's) the products are
    bf16 ones, priced at the bf16 rate (all of them in the dense and
    audio families; beside the fp32 router and scan elsewhere)."""
    dtype = getattr(torch, pdt)
    cfg = registry.smoke_arch(arch)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    res = dryrun.lower_one(
        arch, "train_4k", multi_pod=False, fn_kind="local",
        one_process=True, cfg_override=over,
        mesh_override={"shape": (2, 16)},
        shape_override=base.InputShape("s", 32, 8, "train"), verbose=False,
        **({} if pdt == "bfloat16" else {"param_dtype": dtype}))
    bundle = make_train_step(cfg, base.VRLConfig(update_backend="xla"),
                             device="cpu", param_dtype=dtype)
    st = bundle.init_state(0, 2)
    gen = torch.Generator().manual_seed(0)
    lab = torch.randint(0, cfg.vocab_size, (2, 4, 32), generator=gen)
    tok = (torch.randn(2, 4, 32, cfg.frontend_dim, generator=gen).to(dtype)
           if cfg.frontend == "codec" else lab)
    with FlopCounterMode(display=False) as fm:
        bundle.local_step(st, tok, lab)
    total = fm.get_total_flops()
    assert res.roofline.hlo_flops == total > 0
    by = res.roofline.flops_by_dtype
    if pdt == "float32" or cfg.family in ("dense", "audio"):
        assert by == {pdt: total}
    else:
        # the MoE router and the SSM scan's decays stay fp32, as the
        # reference's
        assert set(by) == {"bfloat16", "float32"}
        assert sum(by.values()) == total and by["bfloat16"] > by["float32"]
    assert res.counted.launches() == {"fused_local_sgd": 1}
    assert res.per_device_bytes > res.counted.base_bytes > 0


@pytest.mark.parametrize("fn", ["prefill", "decode"])
def test_meta_serving_flops_equal_cpu_flop_counter(fn):
    """The smoke qwen2-0.5b's prefill (64 x 32) and decode step against a
    32-slot cache, bf16 as the dry run serves, counted on meta tensors in
    one process and on the CPU; on the (16, 16) serving grid rank 0 counts
    its share (4 of the 64 requests, its 1/16 of the vocab and of the
    MLP's ff, the cache's slots split over "model") and the grid's
    collectives, and the row's chips are the whole grid."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import make_prefill, make_serve_step
    cfg = registry.smoke_arch("qwen2-0.5b")
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    shape = base.InputShape("s", 32, 64, fn)
    kw = dict(cfg_override=over, shape_override=shape, verbose=False)
    res = dryrun.lower_one("qwen2-0.5b", "s", multi_pod=False, fn_kind=fn,
                           one_process=True, **kw)
    params = transformer.init_params(cfg, 0, dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fm:
        with torch.no_grad():
            if fn == "prefill":
                make_prefill(cfg, 32)(params, torch.zeros(64, 32,
                                                          dtype=torch.long))
            else:
                cache = transformer.init_cache(cfg, 64, 32)
                make_serve_step(cfg)(params, cache,
                                     torch.zeros(64, 1, dtype=torch.long),
                                     31)
    assert res.roofline.hlo_flops == fm.get_total_flops() > 0
    assert res.roofline.chips == 1
    assert res.counted.counts == {} and res.counted.launches() == {}
    grid = dryrun.lower_one("qwen2-0.5b", "s", multi_pod=False, fn_kind=fn,
                            **kw)
    assert grid.roofline.chips == 256 and grid.counted.launches() == {}
    assert 0 < grid.roofline.hlo_flops < res.roofline.hlo_flops / 16
    assert set(grid.counted.counts) == {"tensor"}


# --------------------------------------------- the dry mesh against gloo
def _spawn(fn, world, *args):
    tmp.start_processes(fn, args=(world, *args), nprocs=world,
                        start_method="spawn")


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_gloo")
    out = {}
    for world in (2, 4):
        _spawn(DR.counts, world, str(d / f"store{world}"),
               str(d / f"counts{world}"))
        out.update(torch.load(str(d / f"counts{world}.rank0"),
                              weights_only=False))
    return out


@pytest.mark.parametrize("case", DR.FLAT_CASES + ("rows",)
                         + tuple(DR.FSDP_CASES))
def test_dry_mesh_counts_equal_gloo(gloo_counts, case):
    real = gloo_counts[case]
    if case in DR.FSDP_CASES:
        # one worker over fsdp ranks (x shard ranks): the dense and MoE
        # smoke models' rounds, remat on (the MoE's collectives run again
        # in each layer's recompute)
        f, s = DR.FSDP_CASES[case]
        mesh = mesh_mod.dry_engine_mesh(1, f * s, fsdp=f, shards=s)
        dry = DR.fsdp_counts(mesh, meta=True, shards=s)
        real_counts = real["counts"]
        assert all("grad" in c for c in dry)
        assert sum("moe" in c for c in dry) == len(dry) // 2
    elif case == "rows":
        mesh = mesh_mod.dry_engine_mesh(DR.SHARD_W, DR.SHARD_W * DR.SHARDS,
                                        shards=DR.SHARDS)
        dry = DR.shard_counts(mesh, meta=True)
        real_counts = tuple(real["counts"])
        dry = tuple(dry)
    else:
        hier = DR.port_cfg(case).hier is not None
        mesh = mesh_mod.dry_engine_mesh(DR.W, 2,
                                        pods=DR.PODS if hier else 0)
        dry = DR.case_counts(case, mesh, meta=True)
        real_counts = real["counts"]
    assert tuple(mesh.shape) == tuple(real["grid"])
    assert dry == real_counts
    assert any(c for c in (dry if case != "rows" else dry[1])), dry


# ------------------------------------------------------------------- CLI
def _cli(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("budget,rc", [(700_000_000, 0), (600_000_000, 1)])
def test_cli_engine_mem_gate(budget, rc):
    """The CI gate's command (qwen2-0.5b at 8 row shards, bf16 moments) with
    no card visible, on the reference's layout (bf16 params: 626,524,160 B
    a device)."""
    proc = _cli("--engine-mem", "--arch", "qwen2-0.5b", "--shards", "8",
                "--moment-dtype", "bfloat16", "--gate-bytes", str(budget))
    assert proc.returncode == rc, proc.stderr[-2000:]
    if rc:
        assert "engine-mem gate FAILED (the reference's layout)" in \
            proc.stderr
    else:
        assert "engine-mem: 1 arch(s) OK" in proc.stdout
        assert "the reference's layout" in proc.stdout


def test_cli_engine_mem_gate_reports_the_port_layout(tmp_path):
    """The gate's point on the state the port trains, the reference's
    layout (bf16 params): 626,524,160 B a device, within the 7e8 budget,
    in the artifact under ``port`` too."""
    out = tmp_path / "mem.jsonl"
    proc = _cli("--engine-mem", "--arch", "qwen2-0.5b", "--shards", "8",
                "--moment-dtype", "bfloat16", "--gate-bytes", "700000000",
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    art = json.loads(out.read_text())
    assert art["per_device_bytes"] == 626_524_160
    assert art["port"]["per_device_bytes"] == 626_524_160
    assert art["port"]["param_dtype"] == "bfloat16"
    assert ("the reference's layout, which the port trains, 626524160 "
            "B/device, within 700000000") in proc.stdout


def test_cli_sync_row_has_the_reference_keys(ref, tmp_path):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--fn", "sync", "--out", str(out)]) == 0
    row = json.loads(out.read_text().splitlines()[0])
    assert set(ref()["lower"]["sync"]) <= set(row)
    assert row["ok"] and row["fn"] == "sync" and row["mesh"] == "single"
    assert row["coll_bytes"] == ref()["lower"]["sync"]["coll_bytes"]


def test_cli_fsdp_layout_is_refused_with_its_reason(tmp_path):
    """kimi-k2's training step runs with a worker over its 16 fsdp ranks;
    its serving runs on the 2D-sharded layout of the (16, 16) grid: rank
    0's 1/256 of the weights, the d dims gathered over "data" ("weights"),
    the tensor ranks' sums and gathers over "model" ("tensor"), the routed
    layer's counts over "data" ("moe"), ``chips`` the whole grid."""
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k",
                        "--fn", "local", "--out", str(out)]) == 0
    row = json.loads(out.read_text().splitlines()[0])
    assert row["ok"] is True and row["chips"] == 16
    assert row["collectives"]["grad"]["fsdp"]["calls"] == 1
    assert dryrun.main(["--arch", "kimi-k2-1t-a32b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    row = json.loads(out.read_text().splitlines()[1])
    assert row["ok"] is True and row["error"] == ""
    assert row["chips"] == 256 and row["per_device_bytes"] > 0
    cfg = registry.padded_arch("kimi-k2-1t-a32b", registry.mesh_roles(
        "kimi-k2-1t-a32b", serving=True))
    layers = cfg.num_layers
    assert {k: {g: v["calls"] for g, v in d.items()}
            for k, d in row["collectives"].items()} == {
        # norms 2, attention 4, router 1, experts 3, shared 3 a layer; the
        # final norm, lm_head and the embedding
        "weights": {"data": 13 * layers + 3},
        # wo, the experts a layer, the flash-decode's 3 (kv 8 over 16
        # ranks: the cache splits by slots); the embedding, the logits
        "tensor": {"model": 5 * layers + 2},
        "moe": {"data": layers}}
    # a rank's weights: 1/256 of the model's bf16 bytes
    assert row["per_device_bytes"] > 2 * cfg.param_count() // 256


FSDP_ROWS = [(a, m, fn) for a in sorted(registry._FSDP_ARCHS)
             for m in ("single", "multi") for fn in ("local", "sync")]


@pytest.mark.parametrize("arch,mesh,fn", FSDP_ROWS)
def test_fsdp_training_rows_run(ref, arch, mesh, fn):
    """The reference's FSDP archs' training steps on both meshes: one
    worker over the 16 "data" ranks of its FSDP axis (2 workers over the
    pods on the multi mesh), each rank's batch 16 sequences of the
    worker's 256 (8 of 128 on the multi mesh), its gradient averaged over
    them once a step; ``model_flops`` equal to the reference's."""
    multi = mesh == "multi"
    res = dryrun.lower_one(arch, "train_4k", multi_pod=multi, fn_kind=fn,
                           verbose=False)
    row = res.to_json()
    assert row["ok"] and row["chips"] == (32 if multi else 16)
    assert res.counted.mesh.shape == ((1, 2, 16) if multi else (1, 1, 16))
    if fn == "sync":
        assert row["kernels"] == {"fused_sync_vrl": 1}
        assert row["model_flops"] == 0.0
        assert set(row["collectives"]) == {"state"}
        return
    assert row["kernels"] == {"fused_local_sgd": 1}
    assert row["model_flops"] == ref()["model_flops"][f"{arch}/{mesh}"]
    # the bf16 gradient's mean carries fp32 on the wire
    _, r, c = dryrun.engine_mem(arch, verbose=False)["buffers"]["params"][
        "shape"]
    assert row["collectives"]["grad"] == {"fsdp": {
        "calls": 1, "bytes": r * c * 4, "async": 0}}
    assert ("moe" in row["collectives"]) == (arch != "chameleon-34b")
    assert row["hlo_flops"] > 0


def test_dryrun_touches_no_card(monkeypatch):
    """Nothing of the dry run calls into torch.cuda."""
    def boom(*a, **k):
        raise AssertionError("the dry run called torch.cuda")
    for name in ("is_available", "current_device", "synchronize",
                 "current_stream", "device_count"):
        monkeypatch.setattr(torch.cuda, name, boom)
    res = dryrun.lower_one("qwen2-0.5b", "train_4k", multi_pod=False,
                           fn_kind="sync", verbose=False)
    assert res.ok
    dryrun.engine_mem("mamba2-370m", verbose=False)


# ------------------------------------------------------------- the specs
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_refusal_follows_the_specs(arch, multi):
    """Rank 0's parameter blocks follow the specs on every arch and mesh:
    in serving each leaf's dims ÷ the ranks of its spec's axes, the tensor
    and, for kimi-k2 alone, the FSDP axes (its 2D layout), every family's
    tensor axes split (the ssm and hybrid families' too, held whole until
    their ssm_inner split was ported); the reference's FSDP archs train a
    worker over fsdp ranks (``state_specs`` over the FSDP axes)."""
    from repro_torch.models import transformer
    from repro_torch.models.param import abstract
    for serving in (False, True):
        m = registry.mesh_roles(arch, multi_pod=multi, serving=serving)
        c = registry.padded_arch(arch, m)
        fsdp = arch in (registry._FSDP_SERVE_ARCHS if serving
                        else registry._FSDP_ARCHS)
        assert (m.fsdp_size > 1) == fsdp
        if not serving:
            specs = dryrun.state_specs(c, m, base.VRLConfig())
            assert fsdp == any(
                set(m.fsdp_axes) & set(dryrun._entry_axes(e))
                for spec in dryrun.tree_mod.leaves(specs["params"])
                for e in spec)
            continue
        sizes = dict(zip(m.axis_names, m.shape))
        split = set(m.tensor_axes) | set(m.fsdp_axes)
        specs = dryrun.sh.partition_specs(transformer.model_defs(c), c, m)
        whole = abstract(transformer.model_defs(c), torch.bfloat16)
        seen = set()
        for (path, t), (_, spec) in zip(
                dryrun.tree_mod.leaves_with_path(whole),
                dryrun.tree_mod.leaves_with_path(specs)):
            got = dryrun.rank_block(t, spec, m, tensor=True)
            want = []
            for n, e in zip(t.shape, spec):
                axes = [a for a in dryrun._entry_axes(e) if a in split]
                seen |= set(axes)
                want.append(n // math.prod(sizes[a] for a in axes))
            assert tuple(got.shape) == tuple(want), path
        assert bool(seen & set(m.fsdp_axes)) == fsdp
        assert seen & set(m.tensor_axes)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_rank_block_is_rank0s_share(arch, multi):
    """Rank 0's block of each input, by its spec: a train batch is one
    worker's (1, b, ...); a serve batch and its cache 1/16 (1/32) of the
    global batch over the data-like axes, the whole batch where those axes
    do not divide it; on the serving grid the cache's kv heads, or where
    they do not divide the 16 "model" ranks its slots, split over them
    (``init_cache(tp=)``'s block); the SSM state by heads where they
    divide the "model" ranks, else whole (hymba-1.5b's 50 heads), the
    conv window whole (the ssm and hybrid families' cache was held whole
    on a rank until their ssm_inner split was ported)."""
    from repro_torch.models import transformer
    for shape_id in registry.INPUT_SHAPES:
        shape = registry.get_shape(shape_id)
        serving = shape.kind != "train"
        m = registry.mesh_roles(arch, multi_pod=multi, serving=serving)
        c = registry.padded_arch(arch, m)
        ins = dryrun.input_specs(arch, shape_id, m)
        if not serving:
            if m.fsdp_size > 1:
                continue
            spec = dryrun.batch_sharding_spec(
                m, shape.global_batch // m.num_workers,
                ins["tokens"].dim() - 2, worker_stacked=True)
            tok = dryrun.rank_block(ins["tokens"], spec, m)
            assert tok.shape == (1, *ins["tokens"].shape[1:])
            continue
        spec = dryrun.batch_sharding_spec(m, shape.global_batch,
                                          ins["tokens"].dim() - 1,
                                          worker_stacked=False)
        data = m.num_workers * m.fsdp_size
        ranks = data if shape.global_batch % data == 0 else 1
        b = shape.global_batch // ranks
        tok = dryrun.rank_block(ins["tokens"], spec, m, tensor=True)
        assert tok.shape == (b, *ins["tokens"].shape[1:])
        if shape.kind == "decode":
            window = dryrun._decode_window(c, shape)
            eff = min(window or shape.seq_len, shape.seq_len)
            cache = tree_map(
                lambda t, s: dryrun.rank_block(t, s, m, tensor=True),
                ins["cache"],
                dryrun.cache_specs(c, m, shape.global_batch, eff))
            tp = mesh_mod.dry_serve_mesh(m).tp
            want = transformer.init_cache(c, b, shape.seq_len,
                                          window=window, device="meta",
                                          tp=tp)
            assert tree_map(lambda t: tuple(t.shape), cache) == \
                tree_map(lambda t: tuple(t.shape), want), shape_id
            attn = cache if c.family not in ("ssm", "hybrid") \
                else cache.get("attn")
            if attn is not None:
                k = attn["k"].shape
                assert (k[3] == c.num_kv_heads // 16
                        if c.num_kv_heads % 16 == 0
                        else k[2] == eff // 16), (shape_id, k)
            ssm_c = cache if c.family == "ssm" else cache.get("ssm")
            if ssm_c is not None:
                h = c.ssm_num_heads
                assert ssm_c["state"].shape[2] == (
                    h // 16 if h % 16 == 0 else h), (shape_id, h)
                assert ssm_c["conv"].shape[-1] == \
                    c.ssm_d_inner + 2 * c.ssm_state


def _js(x):
    """The port's specs as the reference script writes its own: a spec
    tuple as ["P", entries], a meta tensor as ["S", shape]."""
    if isinstance(x, tuple):
        return ["P", [list(e) if isinstance(e, tuple) else e for e in x]]
    if isinstance(x, torch.Tensor):
        return ["S", list(x.shape)]
    if isinstance(x, dict):
        return {str(k): _js(v) for k, v in x.items()}
    return x


def _vrl(kw):
    from repro_torch.comm import compressors as tcm
    kw = dict(kw)
    if "compress" in kw:
        kw["compress"] = tcm.parse_compressor(kw["compress"])
    return base.VRLConfig(**kw)


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_specs_match_reference(ref, arch, multi, serving):
    specs = ref()["specs"]
    m = registry.mesh_roles(arch, multi_pod=multi, serving=serving)
    c = registry.padded_arch(arch, m)
    key = arch + ("/multi" if multi else "/single") + (
        "/serve" if serving else "/train")
    assert _js(dryrun.cache_specs(c, m, 128, 32768)) == specs[key + "/cache"]
    assert _js(dryrun.cache_specs(c, m, 1, 7)) == specs[key + "/cache1"]
    for b in (1, 16, 256):
        for ws in (False, True):
            assert _js(dryrun.batch_sharding_spec(
                m, b, 1, worker_stacked=ws)) == \
                specs[key + "/batch/%d/%d" % (b, ws)]
    if not serving:
        for tag, kw in SPEC_VRL.items():
            got = _js(dryrun.state_specs(c, m, _vrl(kw)))
            want = specs[key + "/state/" + tag]
            assert got == want, tag
    n = 0
    for shape in registry.INPUT_SHAPES:
        if (registry.get_shape(shape).kind == "train") == serving:
            continue
        got = _js(dryrun.input_specs(arch, shape, m))
        want = specs[key + "/inputs/" + shape]
        # the port's ids are int64 and its decode position a host int
        if "pos" in want:
            assert want.pop("pos") == ["S", []] and isinstance(
                got.pop("pos"), int)
        assert got == want, shape
        n += 1
    assert n == (3 if serving else 1)
