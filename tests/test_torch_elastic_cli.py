"""PyTorch port, the elastic driver (``launch.train --faults --membership
--guard --max-retries --clients --participation``) vs the JAX package's.

* side by side — both CLIs resume the same JAX checkpoint (mamba2-370m's
  smoke model, whose map is smooth enough for the packages' fp32
  roundings to stay ulps apart) with ``--membership --guard --faults
  "nan@1:3,crash@1:4,rejoin@1:8"``, and with ``--clients 8`` over 4
  slots with crash / rejoin / killsave faults: the same metrics events in
  the same order with the same fields (``membership``, ``rollback``,
  ``fault``, ``cohort``, ``checkpoint`` ...), every loss within 1e-5.
* fresh runs — the two CLIs from their own inits (qwen2-0.5b's smoke
  model) give the same ``membership`` / ``rollback`` / ``fault`` /
  ``cohort`` events.
* the guard — a finite scale poison caught by the loss trend, a rollback
  to the newest checkpoint, an invariant alarm feeding the rollback, the
  abort after ``--max-retries`` (the reference's message), the per-leaf
  executor under ``--guard``.
* flags — the fault flags' refusals equal to the reference's.
* mesh — the elastic hierarchy over a gloo group of 2 ranks agrees with
  one process.
"""
import json
import socket

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.fault import FaultSchedule as JFS  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro_torch.fault import FaultSchedule  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.obs.metrics import read_metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = ["--device", "cpu"]
SIDE = ["--arch", "mamba2-370m", "--smoke", "--workers", "4", "--batch",
        "2", "--seq", "40", "--k", "2", "--lr", "0.02", "--backend", "xla",
        "--log-every", "1"]
ELASTIC = ["--membership", "--guard", "--faults",
           "nan@1:3,crash@1:4,rejoin@1:8", "--steps", "10"]
CLIENTS = ["--clients", "8", "--alpha", "0.1", "--faults",
           "crash@2:3,rejoin@2:5,killsave:6", "--ckpt-every", "2",
           "--steps", "8"]
CHAOS = ("membership", "rollback", "fault", "cohort", "checkpoint")


def _losses(recs):
    out = []
    for r in recs:
        for f in ("loss", "local_loss", "avg_model_loss", "final_loss"):
            if f in r and r[f] is not None:
                out.append((r["event"], r.get("t"), f, r[f]))
    return out


def _same_streams(jr, tr, losses=True):
    """The events in order with the same fields and non-float values
    (clocks and paths aside); every loss within 1e-5 when ``losses``."""
    assert [r["event"] for r in tr] == [r["event"] for r in jr]
    skip = {"wall_s", "phases", "path", "wall_s_train", "meta"}
    for a, b in zip(tr, jr):
        assert set(a) == set(b), (a["event"], set(a) ^ set(b))
        for key in set(a) - skip:
            if isinstance(b[key], float) or isinstance(a[key], float):
                continue
            if isinstance(a[key], list) and any(isinstance(x, float)
                                                for x in a[key]):
                # per-worker figures (drift_per_worker): fp32 rounding
                np.testing.assert_allclose(a[key], b[key], rtol=0,
                                           atol=1e-5)
                continue
            if not losses and a["event"] not in CHAOS + ("round", "sync",
                                                         "run_start"):
                continue
            assert a[key] == b[key], (a["event"], key, a[key], b[key])
    if losses:
        lt, lj = _losses(tr), _losses(jr)
        assert [x[:3] for x in lt] == [x[:3] for x in lj]
        for a, b in zip(lt, lj):
            assert abs(a[3] - b[3]) <= 1e-5, (a, b)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The JAX CLI's step-2 checkpoints (a membership run, a client store),
    then both CLIs resumed from each with the chaos flags."""
    d = tmp_path_factory.mktemp("elastic")
    j_launch.main(SIDE + ["--membership", "--steps", "2", "--ckpt",
                          str(d / "j0"), "--ckpt-every", "2"])
    j_launch.main(SIDE + ["--clients", "8", "--alpha", "0.1", "--steps",
                          "2", "--ckpt", str(d / "c0"), "--ckpt-every",
                          "2"])
    out = {}
    for name, flags, start in (("elastic", ELASTIC, "j0"),
                               ("clients", CLIENTS, "c0")):
        common = SIDE + flags + ["--resume", jck.step_dir(str(d / start), 2)]
        j_launch.main(common + ["--metrics", str(d / f"{name}.jax.jsonl"),
                                "--ckpt", str(d / f"{name}.jax")])
        res = t_launch.run(common + CPU + [
            "--metrics", str(d / f"{name}.port.jsonl"),
            "--ckpt", str(d / f"{name}.port")])
        out[name] = (read_metrics(str(d / f"{name}.jax.jsonl")),
                     read_metrics(str(d / f"{name}.port.jsonl")), res)
    return out


def test_elastic_streams_match_reference(side):
    jr, tr, res = side["elastic"]
    _same_streams(jr, tr)
    events = [r["event"] for r in tr]
    assert events[:3] == ["run_start", "restore", "fault"]
    assert events.count("rollback") == 1 and events.count("membership") == 2
    rb = next(r for r in tr if r["event"] == "rollback")
    assert (rb["t_fail"], rb["reason"], rb["back_to"]) == (
        4, "non-finite state", 2)
    assert [r["active"] for r in tr if r["event"] == "membership"] == [
        [1, 0, 1, 1], [1, 1, 1, 1]]
    assert [r["participants"] for r in tr if r["event"] == "sync"] == [
        4, 3, 3, 4]
    assert res.elastic["rollbacks"] == [(4, "non-finite state", 2)]
    assert len(res.elastic["snapshot_s"]) == 5


def test_client_streams_match_reference(side):
    jr, tr, res = side["clients"]
    _same_streams(jr, tr)
    cohorts = [r["clients"] for r in tr if r["event"] == "cohort"]
    assert len(cohorts) == 3 and all(len(c) == 4 for c in cohorts)
    killed = [r["killed"] for r in tr if r["event"] == "checkpoint"]
    assert killed == [False, True, False]
    assert tr[0]["meta"]["client_store"] == jr[0]["meta"]["client_store"]
    assert len(res.elastic["gather_s"]) == len(res.elastic["scatter_s"]) == 3


FRESH = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "4", "--steps",
         "10", "--k", "2", "--batch", "2", "--seq", "32", "--lr", "0.05",
         "--log-every", "1"]


@pytest.mark.parametrize("case", ["elastic", "clients"])
def test_fresh_runs_hold_the_reference_events(tmp_path, case):
    """The acceptance commands from each package's own init: the same
    chaos events (the losses differ: the inits are each package's)."""
    flags = (["--membership", "--guard", "--faults",
              "nan@1:3,crash@1:4,rejoin@1:8"] if case == "elastic"
             else ["--clients", "8", "--faults", "crash@2:3,rejoin@2:5,"
                   "killsave:6", "--ckpt-every", "2", "--steps", "8"])
    j_launch.main(FRESH + flags + ["--metrics", str(tmp_path / "j.jsonl"),
                                   "--ckpt", str(tmp_path / "j")])
    t_launch.run(FRESH + flags + CPU + ["--metrics",
                                        str(tmp_path / "t.jsonl"),
                                        "--ckpt", str(tmp_path / "t")])
    jr = read_metrics(str(tmp_path / "j.jsonl"))
    tr = read_metrics(str(tmp_path / "t.jsonl"))
    _same_streams(jr, tr, losses=False)
    pick = [r for r in tr if r["event"] in CHAOS[:4]]
    assert pick, "no chaos event"


# ------------------------------------------------------------------ guard
GUARD = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "4", "--batch",
         "2", "--seq", "32", "--k", "2", "--lr", "0.05", "--guard",
         "--log-every", "1"] + CPU


def test_guard_catches_scale_poison_and_rolls_back(capsys):
    """A finite scale poison passes every finiteness check: ONLY the loss
    trend catches it; the rollback replays the round clean (the fault is
    consumed)."""
    res = t_launch.run(GUARD + ["--steps", "6", "--max-retries", "2",
                                "--faults", "scale@1:2:1e3"])
    out = capsys.readouterr().out
    assert "gradient fault in round [2, 4)" in out
    assert "loss blow-up" in out
    assert "non-finite state" not in out
    assert "rolled back to step 2 (retry 1/2)" in out
    assert "done: 6 steps" in out
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()


def test_guard_rolls_back_to_the_newest_checkpoint(tmp_path, capsys):
    """With --ckpt the rollback restores the newest checkpoint at or
    before the failed round, and the replay from it is the run without
    the fault from there (the fault consumed)."""
    argv = GUARD + ["--steps", "8", "--ckpt", str(tmp_path / "a"),
                    "--ckpt-every", "4", "--membership"]
    res = t_launch.run(argv + ["--faults", "nan@2:5"])
    assert "rolled back to step 4 (retry 1/2)" in capsys.readouterr().out
    assert res.elastic["rollbacks"] == [(6, "non-finite state", 4)]
    clean = t_launch.run(argv[:-5] + ["--ckpt", str(tmp_path / "b"),
                                      "--ckpt-every", "4", "--membership"])
    assert res.losses[:4] == clean.losses[:4]
    assert res.losses[-4:] == clean.losses[-4:]
    assert torch.equal(res.state.params, clean.state.params)


def test_invariant_alarm_feeds_the_guard_and_aborts(tmp_path):
    """An alarm below the fp32 floor trips every round: a divergence each
    time, retried --max-retries times, then the reference's abort."""
    flags = ["--steps", "6", "--max-retries", "1", "--invariant-alarm",
             "1e-30", "--metrics"]
    with pytest.raises(SystemExit) as et:
        t_launch.run(GUARD + flags + [str(tmp_path / "t.jsonl")])
    with pytest.raises(SystemExit) as ej:
        j_launch.main([a for a in GUARD if a not in CPU] + flags
                      + [str(tmp_path / "j.jsonl")])
    assert str(et.value) == str(ej.value)
    assert "aborting" in str(et.value)
    tr = read_metrics(str(tmp_path / "t.jsonl"))
    jr = read_metrics(str(tmp_path / "j.jsonl"))
    assert [r["event"] for r in tr] == [r["event"] for r in jr]
    rbs = [r for r in tr if r["event"] == "rollback"]
    assert rbs[0]["reason"].startswith("invariant alarm")
    assert rbs[-1]["aborted"] is True


def test_guard_on_the_per_leaf_executor(capsys):
    res = t_launch.run(GUARD + ["--steps", "4", "--backend", "reference",
                                "--faults", "nan@0:1"])
    out = capsys.readouterr().out
    assert "rolled back to step 0 (retry 1/2)" in out
    assert np.isfinite(res.losses).all()


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("flags", [
    ["--max-retries", "-1"],
    ["--workers", "2", "--faults", "nan@5:3"],
    ["--workers", "2", "--faults", "crash@0:3,crash@1:4"],
    ["--workers", "2", "--faults", "frob@0:3"],
    ["--workers", "2", "--faults", "scale@1:3"],
    ["--faults", "nan@0:3", "--no-round"],
    ["--membership", "--backend", "reference"],
    ["--faults", "crash@0:3", "--backend", "reference"],
])
def test_bad_fault_flags_match_reference(flags):
    base = ["--smoke", "--steps", "4"]
    with pytest.raises(SystemExit) as ej:
        j_launch.main(base + flags)
    with pytest.raises(SystemExit) as et:
        t_launch.run(base + flags + CPU)
    assert str(et.value) == str(ej.value)


def test_random_faults_are_the_reference_draws(capsys):
    args = t_launch.parse_args(["--smoke", "--steps", "40", "--workers",
                                "4", "--faults", "random", "--fault-seed",
                                "5", "--ckpt", "unused"])
    fs = t_launch.build_faults(args)
    assert fs.describe() == JFS.random(40, 4, seed=5,
                                       killsave=True).describe()
    assert isinstance(fs, FaultSchedule)


# ------------------------------------------------------------------- mesh
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_elastic_hier_on_a_gloo_mesh_matches_one_process(tmp_path):
    """hier (2, 2) with --membership --guard and faults over 2 gloo ranks
    ((1, 2) rank grid): the losses of one process (fp32 rounding); the
    repairs, the guard's verdicts and the gradient poison on every rank."""
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32", "--lr", "0.05", "--workers", "4", "--steps",
            "8", "--algorithm", "hier_vrl_sgd", "--pods", "2", "--k1", "2",
            "--k2", "4", "--membership", "--guard", "--faults",
            "nan@0:1,crash@3:2,crash@2:4,rejoin@2:6"]
    tmp.start_processes(R.cli, args=(2, _free_port(), argv + ["--mesh-grid"],
                                     str(tmp_path / "cli")),
                        nprocs=2, start_method="spawn")
    ranks = [torch.load(f"{tmp_path / 'cli'}.rank{r}", weights_only=False)
             for r in range(2)]
    one = t_launch.run(argv)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], one.losses, rtol=1e-5)
        np.testing.assert_allclose(res["avg"], one.avg_model_losses,
                                   rtol=1e-5)
        counts = res["collectives"]
        assert counts["membership"]
        # four rounds: sync1 each, sync2 at steps 4 and 8 (a rolled-back
        # round's too: the first round ran twice)
        assert counts["state"]["data"]["calls"] == 5
    assert json.dumps(ranks[0]["invariant"]) == json.dumps(
        ranks[1]["invariant"])


# --------------------------------------------------------------- examples
def test_examples_run_on_the_cpu(capsys):
    """The ported examples: the quickstart (every run, the elastic and
    client ones included) and the federated protocol, at fewer steps."""
    from repro_torch.examples import federated_nonidentical, quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "20"])
    assert set(out) == {"vrl_sgd", "local_sgd", "ssgd", "stl_sgd",
                        "vrl+int8", "vrl+ovlp", "vrl+shard", "vrl+elastic",
                        "vrl+clients"}
    for tag, losses in out.items():
        assert np.isfinite(losses).all(), tag
    assert len(out["vrl+elastic"]) == 20 and len(out["vrl+clients"]) == 1
    res = federated_nonidentical.main(["--device", "cpu", "--steps", "40"])
    assert set(res) == {"ssgd", "vrl_sgd", "vrl_sgd-w", "local_sgd",
                        "easgd"}
    text = capsys.readouterr().out
    assert "run report — quickstart" in text and "label skew" in text
    with pytest.raises(SystemExit, match="multiple of 20"):
        quickstart.main(["--device", "cpu", "--steps", "30"])


@pytest.mark.parametrize("lr,parts", [(0.2, True), (5e-5, False)])
def test_quickstart_sensitivity_to_an_ulp_of_its_init(monkeypatch, lr,
                                                      parts):
    """The quickstart's VRL-SGD run twice on the CPU, the second from its
    initial weights nudged by about one ulp (x · (1 + 1e-7 · N(0, 1))).
    At the example's γ 0.2 the two part past 1e-4 within its 20 steps:
    the tiny model under its init is chaotic there, as the card's and
    the CPU's roundings part them.  At γ 5e-5 (what ``chip_smoke.py``
    holds the card to) they stay within 1e-6 at every step.  Prints each
    step's relative difference."""
    from repro_torch import tree as tm
    from repro_torch.data import lm_token_stream
    from repro_torch.examples import quickstart as qs
    cfg = qs.tiny()
    data = lm_token_stream(qs.WORKERS, qs.SEQ, cfg.vocab_size, steps=20,
                           batch=qs.BATCH, alpha=0.02, seed=0)
    base = qs.train("vrl_sgd", data, torch.device("cpu"), 20, lr=lr)
    init = qs.T.init_params
    gen = torch.Generator().manual_seed(1)

    def nudged(c, seed):
        return tm.tree_map(lambda x: x * (1 + 1e-7 * torch.randn(
            x.shape, generator=gen)), init(c, seed))
    monkeypatch.setattr(qs.T, "init_params", nudged)
    other = qs.train("vrl_sgd", data, torch.device("cpu"), 20, lr=lr)
    rel = np.abs(np.subtract(other, base)) / np.abs(base)
    print(f"γ {lr}: " + " ".join(f"{r:.1e}" for r in rel))
    assert np.isfinite(base).all() and np.isfinite(other).all()
    assert (rel.max() > 1e-4) if parts else (rel.max() <= 1e-6)
