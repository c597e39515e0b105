"""PyTorch port: the client store on row shards (``launch.train --clients M
--mesh-grid --shards S``, ``core.clients.ClientStore`` on a grid with a
shard axis, ``launch.mesh.store_block`` / ``gather_store``) against one
process and against the JAX package's CLI.

Every run starts from one step-0 store checkpoint written by the JAX
package (its smoke qwen2-0.5b draw, wq and wk × 0.1, the ``--shards 2``
layout; the CLIs resume it, as ``tests/test_torch_chaos.py``'s start),
with ``--workers 2 --clients 4 --participation 0.5 --k 2`` for three
rounds and a store checkpoint after each:

* gloo ranks (data 2 × shard 2, world 4) against one process with the same
  flags: each round's losses bitwise; after each round the store the
  ranks' save gathers bitwise the one-process save, and every rank's own
  row block bitwise one process's block of it (``--loss-out``'s
  ``store_digests``); each rank's store holds R/S of every client's rows
  (its bytes: the one-process store's row-split leaves ÷ 2, the rest
  whole); a scatter's "clients" all-gathers run over the rank's shard
  column and move 1/S of the bytes an unsharded grid's would;
* the saved file's leaves restore bitwise into the JAX package's
  ``ClientStore`` (the contract of ``tests/test_torch_clients.py::
  test_store_checkpoints_interchangeable``);
* ranks resumed from the step-2 save continue bitwise the uninterrupted
  ranks (losses and the step-6 save);
* the JAX CLI with the same flags on 4 XLA host devices (``--mesh-grid``,
  data 2 × shard 2): its round losses and averaged-model losses within
  rtol 1e-5 of the ranks' (``tests/test_torch_clients.py``'s mesh
  tolerance), its step-6 store within rtol 1e-5 (Δ atol 1e-4, x̂'s
  rounding over k·γ).

Ranks are spawned by ``torch.multiprocessing`` (``tests/torch_mesh_ranks.py``
``cli``, the launcher's environment set in each).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import EngineConfig as JEng  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.train_loop import make_train_step as j_train_step  # noqa
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.obs.metrics import read_metrics  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, SHARDS, STEPS, K, M = 4, 2, 6, 2, 4
FLAGS = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--clients",
         str(M), "--participation", "0.5", "--batch", "2", "--seq", "16",
         "--k", str(K), "--lr", "0.05", "--log-every", "1", "--shards",
         str(SHARDS), "--ckpt-every", str(K), "--backend", "xla",
         "--steps", str(STEPS)]
ROUNDS = STEPS // K

START = textwrap.dedent("""
    import sys
    import jax
    from repro import checkpoint as ckpt
    from repro.comm import compressors as comm_mod
    from repro.configs import registry
    from repro.configs.base import EngineConfig, VRLConfig
    from repro.core import clients as clients_mod
    from repro.data import partition as partition_mod
    from repro.models import transformer as T
    from repro.train.train_loop import make_train_step

    cfg = registry.smoke_arch("qwen2-0.5b")
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=%d, learning_rate=0.05,
                    update_backend="xla", engine=EngineConfig(shards=%d))
    eng = make_train_step(cfg, vrl, remat=False).engine

    def soften(t):
        if not isinstance(t, dict):
            return t
        out = {k: soften(v) for k, v in t.items()}
        if "wq" in out and "wk" in out:
            out["wq"], out["wk"] = out["wq"] * 0.1, out["wk"] * 0.1
        return out
    state = eng.init(soften(T.init_params(cfg, jax.random.PRNGKey(0))), 2)
    store = clients_mod.ClientStore(state, %d)
    meta = {"step": 0, "arch": "qwen2-0.5b", "workers": 2, "clients": %d,
            "assignment": partition_mod.assignment_to_meta(
                partition_mod.contiguous_assignment(%d, %d)),
            "flat_spec": eng.spec.meta(),
            "compressors": comm_mod.pair_meta(eng.compressors),
            "moments": ckpt.moments_meta(vrl)}
    ckpt.save(sys.argv[1], store.to_tree(), meta=meta)
""" % (K, SHARDS, M, M, M, M))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(devices: int = 0) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(argv: list, out: str) -> list:
    """``launch.train.run(argv + --mesh-grid)`` on WORLD gloo ranks ->
    each rank's ``--loss-out`` JSON."""
    tmp.start_processes(R.cli, args=(WORLD, _free_port(), argv + [
        "--mesh-grid", "--loss-out", out + ".json"], out),
        nprocs=WORLD, start_method="spawn")
    return [json.load(open(f"{out}.json.rank{r}")) for r in range(WORLD)]


def _arrays(ckpt_dir: str, t: int) -> dict:
    with tck.ArrayFile(os.path.join(tck.step_dir(ckpt_dir, t),
                                    "arrays.npz")) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("clients_shards")
    start = str(d / "start0")
    subprocess.run([sys.executable, "-c", START, start], env=_env(),
                   check=True, capture_output=True, text=True, timeout=600)
    # the JAX CLI on 4 XLA host devices, beside the port's runs
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *FLAGS, "--resume",
         start, "--mesh-grid", "--ckpt", str(d / "jck"), "--metrics",
         str(d / "j.jsonl")], env=_env(WORLD), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = FLAGS + ["--device", "cpu"]
    mesh = _ranks(port + ["--resume", start, "--ckpt", str(d / "mesh"),
                          "--metrics", str(d / "t.jsonl")], str(d / "a"))
    one = t_launch.run(port + ["--resume", start, "--ckpt", str(d / "one"),
                               "--loss-out", str(d / "one.json")])
    with open(d / "one.json") as f:
        one_out = json.load(f)
    resumed = _ranks(port + ["--resume", tck.step_dir(str(d / "mesh"), K),
                             "--ckpt", str(d / "resumed")], str(d / "b"))
    out, err = jax_cli.communicate(timeout=900)
    assert jax_cli.returncode == 0, (out[-3000:], err[-3000:])
    return {"dir": d, "mesh": mesh, "one": one, "one_out": one_out,
            "resumed": resumed, "jax_log": out}


def test_losses_are_one_process_bitwise(runs):
    one = runs["one"]
    assert len(one.losses) == STEPS
    for rec in runs["mesh"]:
        assert rec["losses"] == one.losses
        assert rec["avg_model_losses"] == one.avg_model_losses


@pytest.mark.parametrize("t", range(K, STEPS + 1, K))
def test_store_after_each_round_is_one_process(runs, t):
    """The store the ranks' save gathers after the round ending at ``t``
    equals one process's save, leaf for leaf and bit for bit; and each
    rank's own row block hashes as one process's block of it."""
    d = runs["dir"]
    a, b = _arrays(str(d / "mesh"), t), _arrays(str(d / "one"), t)
    assert sorted(a) == sorted(b)
    assert {"clients/params", "clients/delta", "server_params"} <= set(a)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key],
                                                               b[key]), key
    r = t // K - 1
    want = runs["one_out"]["store_digests"][r]
    for rec in runs["mesh"]:
        got = rec["store_digests"][r]
        assert sorted(got) == sorted(want)
        for key, blocks in got.items():
            i = 0 if len(want[key]) == 1 else rec["shard"]
            assert blocks == [want[key][i]], (t, key, rec["shard"])


def test_each_rank_holds_its_rows_and_moves_one_shard(runs):
    """A rank's store: R/S of every client's rows, its bytes the
    one-process store's row-split leaves ÷ S and the rest whole; its
    state's rows R/S; the scatter's all-gathers over its shard column's
    worker ranks, 1/S of the bytes an unsharded grid's would move."""
    store = runs["one"].store
    split = whole = 0
    # ``nbytes`` counts the client tree (the consensus row apart)
    for _, leaf in tree_mod.state_leaves(store.to_tree()["clients"]):
        nb = (leaf.numel() * leaf.element_size()
              if isinstance(leaf, torch.Tensor) else 4)
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2:
            split += nb
        else:
            whole += nb
    rows = runs["one"].state.params.shape[-2]
    lanes = runs["one"].state.params.shape[-1]
    unsharded = 2 * rows * lanes * 4        # params and Δ, one slot a rank
    assert sorted(rec["shard"] for rec in runs["mesh"]) == [0, 0, 1, 1]
    for rec in runs["mesh"]:
        assert split + whole == store.nbytes
        assert rec["store_bytes"] == split // SHARDS + whole
        assert rec["state_shapes"]["params"] == [1, rows // SHARDS, lanes]
        clients = rec["collectives"]["clients"]
        assert set(clients) == {"pod+data"}
        assert clients["pod+data"]["calls"] == 2 * ROUNDS
        assert clients["pod+data"]["bytes"] * SHARDS == ROUNDS * unsharded
        assert rec["collectives"]["state"]["pod+data"]["calls"] == ROUNDS


def test_saved_store_restores_in_the_jax_package(runs):
    """The ranks' step-6 save restores into the JAX package's store of the
    same layout, every leaf bitwise the file's."""
    path = tck.step_dir(str(runs["dir"] / "mesh"), STEPS)
    cfg = jreg.smoke_arch("qwen2-0.5b")
    vrl = JVRL(algorithm="vrl_sgd", comm_period=K, learning_rate=0.05,
               update_backend="xla", engine=JEng(shards=SHARDS))
    eng = j_train_step(cfg, vrl, remat=False).engine
    store = jclients.ClientStore(
        eng.init(JT.init_params(cfg, jax.random.PRNGKey(1)), 2), M)
    store.load_tree(jck.restore(path, store.to_tree()))
    want = _arrays(str(runs["dir"] / "mesh"), STEPS)
    got = {k: np.asarray(v) for k, v in _flatten(store.to_tree()).items()}
    assert sorted(got) == sorted(want)
    for key, v in got.items():
        assert np.array_equal(v, want[key]), key
    assert int(np.asarray(got["clients/step"])) == STEPS


def test_resumed_ranks_continue_bitwise(runs):
    for rec, full in zip(runs["resumed"], runs["mesh"]):
        assert rec["losses"] == full["losses"][K:]
    a = _arrays(str(runs["dir"] / "resumed"), STEPS)
    b = _arrays(str(runs["dir"] / "mesh"), STEPS)
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def _events(path: str, event: str, field: str) -> np.ndarray:
    return np.array([r[field] for r in read_metrics(path)
                     if r["event"] == event])


@pytest.mark.parametrize("event,field", [("round", "loss"),
                                         ("eval", "avg_model_loss")])
def test_trajectory_matches_the_jax_cli(runs, event, field):
    assert "'shard': 2" in runs["jax_log"]          # its mesh: data 2 x 2
    d = runs["dir"]
    ref = _events(str(d / "j.jsonl"), event, field)
    got = _events(str(d / "t.jsonl"), event, field)
    assert len(ref) == len(got) >= ROUNDS
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_store_matches_the_jax_cli(runs):
    a = _arrays(str(runs["dir"] / "mesh"), STEPS)
    b = _arrays(str(runs["dir"] / "jck"), STEPS)
    assert sorted(a) == sorted(b)
    for key in a:
        # Δ = (x̂ − x)/(kγ): x̂'s rounding over k·γ = 0.1
        np.testing.assert_allclose(
            a[key], b[key], rtol=1e-5,
            atol=1e-4 if key.endswith("delta") else 1e-6, err_msg=key)


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_engine_mem_sizes_a_ranks_store(shards):
    """``engine_mem(clients=)`` beside the store's host bytes sizes one
    rank's on a grid of ``shards`` row shards: every buffer's rows split
    over them (qwen2-0.5b's, Adam: params, Δ and both moments), so ÷ S;
    the whole store at S = 1."""
    from repro_torch.launch import dryrun
    art = dryrun.engine_mem("qwen2-0.5b", clients=64, shards=shards,
                            verbose=False)
    assert all(b["shape"][-2] % shards == 0 for b in art["buffers"].values())
    assert art["client_store_rank_bytes"] * shards == \
        art["client_store_bytes"]
