"""PyTorch port, telemetry vs the JAX package (``repro_torch.obs`` and
``Engine.diagnostics``).

* unit — the stream writer/reader, the schema guard, the phase timers,
  the reporter and the legacy converter (the reference's cases of
  ``tests/test_obs.py``), and streams written by either package read by
  the other's reader.
* engine — ``Engine.diagnostics`` on identical states (random buffers,
  carried into the port by a JAX checkpoint) within 1e-5 relative of the
  JAX engine's, flat and hierarchical, key for key; the reference's alarm
  cases: a seeded Σ Δ violation, a NaN-poisoned worker, and the wire bytes
  against the actual compressed payload; the pass leaves the state as it
  was.
* driver — the port's ``--metrics`` stream and the reference's, resumed
  from the same JAX-CLI checkpoint with the same smoke flags: the same
  event sequence and fields (``wall_s`` and the timers aside), the run
  descriptions equal, every loss within 1e-5 (also as ``report.diff``
  reads them); ``--invariant-alarm`` without ``--guard`` prints and
  continues; the flag refusals; the report CLI over both streams; on a
  gloo mesh of 2 ranks the diagnostics pass leaves one model-state
  all-reduce a round.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import EngineConfig as JEC  # noqa: E402
from repro.configs.base import HierConfig as JHC  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.obs import diagnostics as j_diag  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro.obs.metrics import MetricsWriter as JWriter  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import EngineConfig as TEC  # noqa: E402
from repro_torch.configs.base import HierConfig as THC  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.obs import convert, report  # noqa: E402
from repro_torch.obs import diagnostics as obs_diag  # noqa: E402
from repro_torch.obs.metrics import (SCHEMA_VERSION,  # noqa: E402
                                     MetricsWriter, NullWriter,
                                     read_metrics, run_meta)
from repro_torch.obs.timers import PhaseTimers, percentile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ unit
def test_writer_reader_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsWriter(path, run_meta={"arch": "x", "workers": 2}) as mw:
        assert mw.active
        mw.emit("round", t=2, r=1, loss=torch.tensor(1.5),
                wire_bytes=np.int64(4096))
        mw.emit("diag", t=2, drift_per_worker=torch.arange(2.0))
        mw.emit("run_end", steps=2, avg_model_loss=1.25)
    recs = read_metrics(path)
    assert [r["event"] for r in recs] == ["run_start", "round", "diag",
                                         "run_end"]
    assert all(r["schema"] == SCHEMA_VERSION for r in recs)
    assert run_meta(recs) == {"arch": "x", "workers": 2}
    assert recs[1]["loss"] == 1.5 and recs[1]["wire_bytes"] == 4096
    assert recs[2]["drift_per_worker"] == [0.0, 1.0]
    assert recs[0]["wall_s"] == 0.0
    assert all(recs[i]["wall_s"] <= recs[i + 1]["wall_s"]
               for i in range(len(recs) - 1))


def test_streams_cross_read(tmp_path):
    """A stream written by either package reads in the other's reader and
    report."""
    from repro.obs.metrics import read_metrics as j_read
    pj, pt = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    for writer, path in ((JWriter, pj), (MetricsWriter, pt)):
        with writer(path, run_meta={"arch": "a", "workers": 2}) as mw:
            mw.emit("round", t=2, r=1, k=2, loss=2.0, wire_bytes=8)
            mw.emit("run_end", steps=2, avg_model_loss=1.5, rounds=1)
    for path in (pj, pt):
        a, b = read_metrics(path), j_read(path)
        assert [dict(r, wall_s=0) for r in a] == [dict(r, wall_s=0)
                                                   for r in b]
        assert report.summarize(a) == j_report.summarize(b)


def test_reader_rejects_newer_schema_and_garbage(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"schema": SCHEMA_VERSION + 1,
                             "event": "round"}) + "\n")
    with pytest.raises(ValueError, match="newer than this reader"):
        read_metrics(str(p))
    p.write_text('{"no_event": 1}\n')
    with pytest.raises(ValueError, match="'schema' and 'event'"):
        read_metrics(str(p))
    p.write_text("not json\n")
    with pytest.raises(ValueError, match="invalid JSON"):
        read_metrics(str(p))


def test_null_writer_is_inert():
    nw = NullWriter()
    assert not nw.active and nw.path is None
    nw.emit("round", t=1)
    nw.close()


def test_phase_timers_percentiles():
    t = PhaseTimers()
    for ms in (1, 2, 3, 4, 100):
        t.add("round", ms / 1e3)
    with t.phase("eval"):
        pass
    s = t.summary()
    assert s["round"]["n"] == 5
    assert s["round"]["p50_ms"] == pytest.approx(3.0)
    assert s["round"]["p95_ms"] == pytest.approx(100.0)
    assert s["eval"]["n"] == 1
    assert percentile([5.0], 95) == 5.0


def test_report_summarize_and_diff(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsWriter(path, run_meta={"arch": "a", "algorithm": "vrl_sgd",
                                       "workers": 2, "steps": 4}) as mw:
        mw.emit("round", t=2, r=1, k=2, loss=2.0, wire_bytes=1024)
        mw.emit("sync", t=2, r=1, wire_bytes=1024, participants=2)
        mw.emit("diag", t=2, r=1, delta_residual=1e-6, drift_sq_mean=0.5,
                zeta_sq_proxy=3.0, nonfinite_workers=0.0, alarms=[])
        mw.emit("eval", t=2, r=1, avg_model_loss=1.9, local_loss=2.0)
        mw.emit("checkpoint", t=2, killed=False, path="x")
        mw.emit("run_end", steps=4, final_loss=1.8, avg_model_loss=1.8,
                rounds=2, phases={"round": {"n": 2, "total_s": 1.0,
                                            "mean_ms": 500.0,
                                            "p50_ms": 500.0,
                                            "p95_ms": 600.0}})
    recs = read_metrics(path)
    text = report.summarize(recs, label="unit")
    for needle in ("run report — unit", "loss trajectory",
                   "algorithm health", "delta_residual", "checkpoint",
                   "wall-clock phases", "avg_model_loss=1.8"):
        assert needle in text, needle
    d = report.diff(recs, recs, labels=("L", "R"))
    assert "avg_model_loss" in d and "checkpoints" in d
    partial = [r for r in recs if r["event"] != "run_end"]
    assert "partial" in report.summarize(partial)


def test_converter_roundtrip(tmp_path):
    legacy = {"arch": "a", "payload_bytes": 7,
              "table": {"0.25": {"workers": 2, "bytes": 14},
                        "1.0": {"workers": 8, "bytes": 56}}}
    recs = convert.records_from_legacy(legacy, "comm_cohort")
    assert recs[0]["event"] == "run_start" and recs[0]["source"] == "bench"
    assert convert.legacy_view(recs) == legacy
    nested = {"horizons": [10], "table": {
        "ssgd/none": {"10": {"rounds": 10, "bytes": 100}},
        "vrl/none": {"10": {"rounds": 1, "bytes": 10}}}}
    recs2 = convert.records_from_legacy(nested, "comm_compress")
    keys = sorted(tuple(r["key"]) for r in recs2 if r["event"] == "bench")
    assert keys == [("ssgd/none", "10"), ("vrl/none", "10")]
    assert convert.legacy_view(recs2) == nested
    rows = [{"coll_bytes": 1}, {"coll_bytes": 2}]
    assert convert.legacy_view(convert.records_from_legacy(
        rows, "comm_bench")) == rows
    src = tmp_path / "legacy.json"
    src.write_text(json.dumps(legacy))
    canon = str(tmp_path / "canon.jsonl")
    convert.convert_file(str(src), canon)
    back = str(tmp_path / "back.json")
    convert.convert_file(canon, back)
    assert json.load(open(back)) == legacy


# ---------------------------------------------------------------- engine
TEMPLATE = {"w": (48, 16), "b": (17,)}
DIAG_CASES = {
    "vrl_sgd+sgd": dict(algorithm="vrl_sgd"),
    "bvr_l_sgd+adam": dict(algorithm="bvr_l_sgd", inner_optimizer="adam"),
    "easgd+momentum": dict(algorithm="easgd", inner_optimizer="momentum",
                           momentum=0.9),
    "vrl_sgd+int8": dict(algorithm="vrl_sgd", compress="int8"),
    "adam+sm3+bf16": dict(algorithm="vrl_sgd", inner_optimizer="adam",
                          sm3=True, moment_dtype="bfloat16",
                          engine=dict(block=8, shards=2)),
    "hier+int8": dict(algorithm="hier_vrl_sgd", compress="int8",
                      hier=dict(k1=2, k2=4, grid=(2, 2))),
    "hier+adam": dict(algorithm="hier_vrl_sgd", inner_optimizer="adam",
                      hier=dict(k1=2, k2=4, grid=(2, 2))),
}


def _cfgs(**kw):
    kw = dict(comm_period=4, learning_rate=0.05, warmup=False, **kw)
    comp, hier, eng = (kw.pop("compress", None), kw.pop("hier", None),
                       kw.pop("engine", None))
    cj = JVRL(update_backend="xla", **kw,
              compress=jcc.parse_compressor(comp) if comp else None,
              hier=JHC(**hier) if hier else None,
              **({"engine": JEC(**eng)} if eng else {}))
    ct = TVRL(update_backend="xla", **kw,
              compress=tcc.parse_compressor(comp) if comp else None,
              hier=THC(**hier) if hier else None,
              **({"engine": TEC(**eng)} if eng else {}))
    return cj, ct


def _random_states(case, tmp_path, seed=0):
    """The same random state in both engines: every float buffer of the
    JAX engine's W = 4 state filled from numpy (pad lanes too), carried
    into the port by a JAX checkpoint."""
    cj, ct = _cfgs(**DIAG_CASES[case])
    ej = jeng.make_engine(cj, {k: jnp.zeros(s) for k, s in TEMPLATE.items()})
    et = teng.make_engine(ct, {k: torch.empty(s, device="meta")
                               for k, s in TEMPLATE.items()})
    sj = ej.init({k: jnp.zeros(s) for k, s in TEMPLATE.items()}, 4)
    rng = np.random.RandomState(seed)

    def fill(x):
        if not hasattr(x, "dtype") or not jnp.issubdtype(x.dtype,
                                                         jnp.floating):
            return x
        v = rng.randn(*x.shape).astype(np.float32)
        return jnp.asarray(np.abs(v) if x.ndim and x.shape[-1] == 1
                           else v).astype(x.dtype)
    sj = jax.tree.map(fill, sj)
    d = str(tmp_path / case)
    jck.save_flat_state(d, sj, ej.spec, grid=ej.grid,
                        compressors=jcc.pair_meta(ej.compressors),
                        moments=jck.moments_meta(cj))
    st = tck.restore_flat_state(
        d, et.init({k: torch.zeros(s) for k, s in TEMPLATE.items()}, 4),
        et.spec, grid=et.grid, compressors=tcc.pair_meta(et.compressors),
        moments=tck.moments_meta(ct))
    return ej, et, sj, st


@pytest.mark.parametrize("case", list(DIAG_CASES))
def test_diagnostics_match_reference(tmp_path, case):
    ej, et, sj, st = _random_states(case, tmp_path)
    before = {k: v.clone() for k, v in tm.state_leaves(st)
              if isinstance(v, torch.Tensor)}
    want = j_diag.to_record(jax.jit(ej.diagnostics)(sj))
    got = obs_diag.to_record(et.diagnostics(st))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
    for k, v in tm.state_leaves(st):        # read-only
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k


def _flat_engine(**over):
    _, ct = _cfgs(algorithm="vrl_sgd", **over)
    et = teng.make_engine(ct, {k: torch.empty(s, device="meta")
                               for k, s in TEMPLATE.items()})
    rng = np.random.RandomState(0)
    p0 = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
          for k, s in TEMPLATE.items()}
    return et, et.init(p0, 4)


def test_invariant_monitor_catches_seeded_delta_violation():
    et, state = _flat_engine()
    rec = obs_diag.to_record(et.diagnostics(state))
    assert rec["delta_residual"] < 1e-5
    assert obs_diag.check_alarms(rec, invariant_threshold=1e-3) == []
    bad = state._replace(delta=state.delta.clone())
    bad.delta[0] += 0.5
    rec = obs_diag.to_record(et.diagnostics(bad))
    assert rec["delta_residual"] == pytest.approx(0.125)    # 0.5 / W
    alarms = obs_diag.check_alarms(rec, invariant_threshold=1e-3)
    assert len(alarms) == 1 and "sum-delta" in alarms[0]
    assert rec["zeta_sq_proxy"] > 0.0


def test_invariant_monitor_catches_nan_poisoned_worker():
    et, state = _flat_engine()
    bad = state._replace(params=state.params.clone())
    bad.params[2, 5] = float("nan")
    rec = obs_diag.to_record(et.diagnostics(bad))
    assert rec["nonfinite_workers"] == 1.0
    alarms = obs_diag.check_alarms(rec)
    assert len(alarms) == 1 and "non-finite" in alarms[0]
    assert "NONFINITE" in obs_diag.describe(rec)


def test_wire_bytes_matches_actual_compressed_payload():
    for spec_str in ("int8", "topk"):
        et, _ = _flat_engine(compress=spec_str)
        wire = obs_diag.wire_bytes_per_sync(et)
        payload = torch.linspace(-1.0, 1.0, et.spec.padded).reshape(
            et.spec.rows, et.spec.lanes)
        rep = tcc.compress(et.compressors[0], payload,
                           rows_used=tcc.used_rows(et.spec.size,
                                                   et.spec.lanes))
        assert wire["wire_bytes"] == tcc.rep_nbytes(rep)
        assert wire["wire_bytes"] < wire["raw_bytes"]
        assert wire["wire_bytes2"] is None
    cj, ct = _cfgs(**DIAG_CASES["hier+int8"])
    eh = teng.make_engine(ct, {k: torch.empty(s, device="meta")
                               for k, s in TEMPLATE.items()})
    ej = jeng.make_engine(cj, {k: jnp.zeros(s) for k, s in TEMPLATE.items()})
    assert obs_diag.wire_bytes_per_sync(eh) == j_diag.wire_bytes_per_sync(ej)
    assert obs_diag.wire_bytes_per_sync(None) is None


# ---------------------------------------------------------------- driver
FLAGS = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--batch",
         "2", "--seq", "32", "--k", "2", "--lr", "0.02", "--backend", "xla",
         "--steps", "7"]
CPU = ["--device", "cpu"]
# the two CLIs side by side run mamba2-370m's smoke model (seq 40: a
# padded second SSD chunk): without attention its map is smooth, so the
# packages' fp32 roundings stay apart by ulps over the run.  qwen2's smoke
# model is chaotic under the reference's init (ROADMAP Queue 3): the same
# resumed run parts by 1.6e-3 in the loss one sync after the restore, at
# γ = 0.02 and at 0.002 alike.
SIDE_BY_SIDE = ["--arch", "mamba2-370m", "--smoke", "--workers", "2",
                "--batch", "2", "--seq", "40", "--k", "2", "--lr", "0.02",
                "--backend", "xla", "--steps", "7"]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The JAX CLI trains 7 steps of ``SIDE_BY_SIDE`` and checkpoints every
    2; both CLIs then
    resume its step-2 checkpoint with the same flags and --metrics --diag
    (rounds ending at steps 4 and 6, a one-step tail, checkpoints at 4 and
    6)."""
    d = tmp_path_factory.mktemp("resumed")
    j_launch.main(SIDE_BY_SIDE + ["--ckpt", str(d / "jax0"),
                                  "--ckpt-every", "2"])
    start = jck.step_dir(str(d / "jax0"), 2)
    common = ["--resume", start, "--log-every", "1", "--diag",
              "--ckpt-every", "2"]
    j_launch.main(SIDE_BY_SIDE + common + [
        "--ckpt", str(d / "jax1"), "--metrics", str(d / "jax.jsonl"),
        "--loss-out", str(d / "jax_loss.json")])
    res = t_launch.run(SIDE_BY_SIDE + CPU + common + [
        "--ckpt", str(d / "port1"), "--metrics", str(d / "port.jsonl")])
    return d, res


def _losses(recs):
    """Every loss a stream holds: (event, t, field, value)."""
    out = []
    for r in recs:
        for f in ("loss", "local_loss", "avg_model_loss", "final_loss"):
            if f in r and r[f] is not None:
                out.append((r["event"], r.get("t"), f, r[f]))
    return out


def test_metrics_stream_matches_the_reference(resumed):
    d, res = resumed
    jr = read_metrics(str(d / "jax.jsonl"))
    tr = read_metrics(str(d / "port.jsonl"))
    assert [r["event"] for r in tr] == [r["event"] for r in jr]
    assert [r["event"] for r in tr] == (
        ["run_start", "restore"] + ["round", "sync", "diag", "eval",
                                    "checkpoint"] * 2 + ["tail", "run_end"])
    assert run_meta(tr) == run_meta(jr)
    skip = {"wall_s", "phases", "path", "wall_s_train"}
    for a, b in zip(tr, jr):
        assert set(a) == set(b), (a["event"], set(a) ^ set(b))
        for key in set(a) - skip - {"meta"}:
            if isinstance(b[key], float) or isinstance(a[key], float):
                continue                   # losses and diagnostics: below
            assert a[key] == b[key], (a["event"], key)
    lt, lj = _losses(tr), _losses(jr)
    assert [x[:3] for x in lt] == [x[:3] for x in lj]
    for a, b in zip(lt, lj):
        assert abs(a[3] - b[3]) <= 1e-5, (a, b)
    # the diag records: the same fields, the residual below 1e-5 in both
    for a, b in zip(tr, jr):
        if a["event"] == "diag":
            assert a["alarms"] == b["alarms"] == []
            np.testing.assert_allclose(a["params_rms"], b["params_rms"],
                                       rtol=1e-5)
    # the reporter diffs the two: losses within 1e-5
    for k, v in report._run_metrics(tr).items():
        w = report._run_metrics(jr)[k]
        if k in ("steps", "rounds", "syncs", "checkpoints", "wire_MiB_total"):
            assert v == w, k
        elif k == "avg_model_loss":
            assert abs(v - w) <= 1e-5
    text = report.diff(jr, tr, labels=("jax", "port"))
    assert "avg_model_loss" in text
    # the port's resumed losses against the JAX CLI's own resumed run
    out = json.load(open(d / "jax_loss.json"))
    assert abs(res.avg_model_losses[-1] - out["avg_model_loss"]) <= 1e-5
    assert res.start_step == 2


def test_report_cli_summarises_and_diffs_both_streams(resumed, capsys):
    d, _ = resumed
    pj, pt = str(d / "jax.jsonl"), str(d / "port.jsonl")
    for path in (pj, pt):
        assert report.main([path]) == 0
        text = capsys.readouterr().out
        for needle in ("run report", "loss trajectory", "algorithm health",
                       "delta_residual", "communication:", "event timeline",
                       "restore", "final: steps=7"):
            assert needle in text, (path, needle)
    assert report.main([pj, pt, "-v"]) == 0
    text = capsys.readouterr().out
    assert "run diff: jax.jsonl vs port.jsonl" in text
    assert text.count("run report") == 2
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           pj, pt], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=os.path.join(
                              ROOT, "src")), timeout=120)
    assert proc.returncode == 0 and "run diff" in proc.stdout


def test_training_run_emits_documented_stream(tmp_path):
    m, lo = str(tmp_path / "m.jsonl"), str(tmp_path / "loss.json")
    t_launch.run(FLAGS[:-2] + CPU + ["--steps", "4", "--log-every", "1",
                                     "--metrics", m, "--loss-out", lo])
    recs = read_metrics(m)
    meta = run_meta(recs)
    assert meta["algorithm"] == "vrl_sgd" and meta["workers"] == 2
    assert meta["wire"]["wire_bytes"] > 0
    rounds = [r for r in recs if r["event"] == "round"]
    diags = [r for r in recs if r["event"] == "diag"]
    syncs = [r for r in recs if r["event"] == "sync"]
    assert len(rounds) == 2 and len(syncs) == 2 and len(diags) == 2
    assert syncs[0]["participants"] == 2
    for d in diags:
        for key in ("delta_residual", "drift_sq_mean", "zeta_sq_proxy",
                    "params_rms", "nonfinite_workers"):
            assert np.isfinite(d[key]), key
        assert d["alarms"] == []
    end = recs[-1]
    assert end["event"] == "run_end" and end["steps"] == 4
    assert end["phases"]["round"]["n"] == 2
    assert json.load(open(lo))["avg_model_loss"] == end["avg_model_loss"]


def test_early_exit_stream(tmp_path):
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    t_launch.run(FLAGS[:-2] + CPU + ["--steps", "4", "--ckpt", ck,
                                     "--ckpt-every", "2"])
    t_launch.run(FLAGS[:-2] + CPU + ["--steps", "2", "--ckpt", ck,
                                     "--resume", "auto", "--metrics", m])
    recs = read_metrics(m)
    assert [r["event"] for r in recs] == ["run_start", "restore",
                                          "run_end"]
    assert recs[-1]["steps"] == 4 and np.isfinite(recs[-1]["avg_model_loss"])


def test_invariant_alarm_without_guard_prints_and_continues(tmp_path,
                                                             capsys):
    """Under a lossy compressor Σ Δ is genuinely nonzero, so a near-zero
    --invariant-alarm trips on every diagnosed round; without --guard the
    run prints the alarm and continues (the reference's behaviour)."""
    m = str(tmp_path / "m.jsonl")
    res = t_launch.run(FLAGS[:-2] + CPU + [
        "--steps", "4", "--compress", "topk", "--invariant-alarm", "1e-9",
        "--log-every", "1", "--metrics", m])
    out = capsys.readouterr().out
    assert out.count("invariant alarm (no --guard, continuing)") == 2
    diags = [r for r in read_metrics(m) if r["event"] == "diag"]
    assert len(diags) == 2 and all("sum-delta" in d["alarms"][0]
                                   for d in diags)
    assert len(res.losses) == 4


@pytest.mark.parametrize("flags, msg", [
    (["--invariant-alarm", "-1"], "--invariant-alarm must be >= 0"),
    (["--backend", "reference", "--diag"], "--backend reference has none"),
    (["--backend", "reference", "--invariant-alarm", "0.1"],
     "--backend reference has none"),
])
def test_bad_obs_flags_exit_with_named_message(flags, msg):
    with pytest.raises(SystemExit, match=msg):
        t_launch.run(FLAGS[:-2] + CPU + ["--steps", "2"] + flags)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_diagnostics_on_a_mesh_keep_one_state_all_reduce(tmp_path):
    """Two gloo ranks, --diag and --metrics at every round: the round's
    model-state all-reduce stays one a round; the pass's sums are "eval";
    rank 0's stream holds the diag records, equal to one process's."""
    argv = FLAGS[:-2] + CPU + ["--steps", "6", "--log-every", "1",
                               "--diag", "--mesh-grid"]
    out = str(tmp_path / "r")
    tmp.start_processes(R.cli, args=(2, _free_port(), argv + [
        "--metrics", str(tmp_path / "mesh.jsonl")], out), nprocs=2,
        start_method="spawn")
    for r in range(2):
        counts = torch.load(f"{out}.rank{r}", weights_only=False)[
            "collectives"]
        assert counts["state"]["pod+data"]["calls"] == 3
        assert counts["eval"]["pod+data"]["calls"] > 0
    one = str(tmp_path / "one.jsonl")
    t_launch.run(argv[:-1] + ["--metrics", one])
    dm = [r for r in read_metrics(str(tmp_path / "mesh.jsonl"))
          if r["event"] == "diag"]
    do = [r for r in read_metrics(one) if r["event"] == "diag"]
    assert len(dm) == len(do) == 3
    for a, b in zip(dm, do):
        assert set(a) == set(b)
        for key in ("params_rms", "drift_sq_mean", "zeta_sq_proxy"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
        np.testing.assert_allclose(a["drift_per_worker"],
                                   b["drift_per_worker"], rtol=1e-5,
                                   atol=1e-12)
