"""PyTorch port: engine row shards on a rank grid (``EngineConfig.shards``
over the mesh's "shard" axis; ``launch.train --mesh-grid --shards S``)
against the JAX package.

The reference's own test of row shards,
``tests/test_engine_collectives.py::test_row_sharded_round_is_one_all_reduce``,
fails while tracing under jax 0.9.0 (a ``ShardingTypeError`` in
``repro.core.flat.unflatten_stacked`` on its 33-element leaf, ROADMAP
Queue 3), so the JAX package's sharded mesh cannot be the oracle.  The
port is held to that test's stated contract and to the meshless JAX
engine, which runs unsharded and with the ``shards`` layout:

* on gloo grids of world 4, (data 2 × shard 2) and (data 1 × shard 4),
  with the contract's template (``{"w": (64, 16), "b": (33,)}``, vrl_sgd
  + adam, block 8, W = 2, k = 4, nine steps of sin(3x + t) + 0.1x), each
  rank holds (W_l, R/S, C) of every buffer and SM3's lane stat (W_l, 1,
  256); every sync is one counted "state" all-reduce over the rank's shard
  column, of 1/S of the bytes, and the local steps make none; the
  gathered trajectory is within 1e-6 of the meshless JAX engine at
  shards 1 (the plain executor, update_backend "xla", as the port's CPU
  path), and the SM3 bf16 variant within 1e-5 of the meshless JAX xla
  engine at the same shards;
* the overlapped (2, 2) hierarchy at shards 2 on (data 2 × shard 2)
  against the port's one process at shards 2;
* the refusals: a world that does not split into shards, a mesh whose
  shard axis has another size, a shard axis of several ranks at shards 1;
  ``engine_shard_axis`` as the reference's
  ``test_shard_axis_size_mismatch_fails_loudly`` holds it; ``--clients``
  with row shards on a mesh, refused until the store split its rows,
  runs (data 1 × shard 2), its losses one process's;
* ``launch.train --mesh-grid --shards 2`` at world 2 (data 1 × shard 2):
  losses and the saved file bitwise the one-process run at ``--shards
  2``, and a bitwise resume; at W = 1 too (the gradient's rows a view).

Ranks are spawned by ``torch.multiprocessing`` over a ``file://`` store;
their code is ``tests/torch_shard_ranks.py``.
"""
import json
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as MR  # noqa: E402
import torch_shard_ranks as SR  # noqa: E402
from repro.configs.base import EngineConfig as JEng  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import make_engine as j_make_engine  # noqa: E402
from repro_torch.comm import collectives as coll  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

GRIDS = ((2, 2), (1, 4))        # (data ranks, shard ranks)
ROWS = {1: 8, 2: 16, 4: 32}     # R at block 8: 1,057 elements, 5 rows


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, world, *args):
    tmp.start_processes(fn, args=(world, *args), nprocs=world,
                        start_method="spawn")


def _load(out, world):
    return [torch.load(f"{out}.rank{r}", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rows")
    out = {}
    for data_r, shards in GRIDS:
        world = data_r * shards
        tag = f"{data_r}x{shards}"
        _spawn(SR.row_shards, world, str(d / f"store{tag}"),
               str(d / f"rows{tag}"), shards)
        out[(data_r, shards)] = _load(str(d / f"rows{tag}"), world)
    return out


def jax_params(shards: int, sm3: bool = False) -> dict:
    """The meshless JAX xla engine's final parameter trees over the same
    nine steps."""
    cfg = JVRL(algorithm="vrl_sgd", comm_period=SR.K, learning_rate=SR.LR,
               weight_decay=0.0, warmup=False, update_backend="xla",
               inner_optimizer="adam",
               moment_dtype="bfloat16" if sm3 else "float32", sm3=sm3,
               engine=JEng(block=SR.BLOCK, shards=shards))
    tpl = {k: jnp.zeros(v) for k, v in SR.TEMPLATE.items()}
    eng = j_make_engine(cfg, tpl)
    s = eng.init({k: jnp.asarray(v) for k, v in
                  SR.params0_numpy().items()}, SR.W)

    def grads(params, t):
        return jax.tree.map(lambda x: jnp.sin(3.0 * x + t) + 0.1 * x,
                            params)
    step = jax.jit(lambda s, t: eng.train_step(
        s, grads(eng.params_tree(s), t)))
    for t in range(SR.STEPS):
        s = step(s, jnp.float32(t))
    return {k: np.asarray(v) for k, v in eng.params_tree(s).items()}


def _err(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


@pytest.mark.parametrize("grid", GRIDS)
def test_row_shards_match_the_meshless_jax_engine(runs, grid):
    ref = jax_params(1)
    assert _err(runs[grid][0]["adam"]["params"], ref) <= 1e-6


@pytest.mark.parametrize("grid", GRIDS)
def test_sm3_row_shards_match_the_jax_xla_engine_at_their_shards(runs, grid):
    ref = jax_params(grid[1], sm3=True)
    assert _err(runs[grid][0]["sm3"]["params"], ref) <= 1e-5


@pytest.mark.parametrize("grid", GRIDS)
def test_each_rank_holds_its_rows(runs, grid):
    data_r, shards = grid
    w_l, rows = SR.W // data_r, ROWS[shards]
    for res in runs[grid]:
        assert res["grid"] == {"pod": 1, "data": data_r, "shard": shards}
        for name in ("adam", "sm3"):
            assert res[name]["rows"] == rows
            assert res[name]["shape"] == [w_l, rows // shards, 256]
        assert res["sm3"]["col"] == [w_l, 1, 256]
    assert runs[grid][0]["adam"]["full_shape"] == [SR.W, rows, 256]


@pytest.mark.parametrize("grid", GRIDS)
def test_one_state_all_reduce_a_sync_none_in_the_local_steps(runs, grid):
    data_r, shards = grid
    w_l, rows = SR.W // data_r, ROWS[shards]
    for res in runs[grid]:
        for name in ("adam", "sm3"):
            assert res[name]["local"] == [{}] * SR.STEPS
            # steps 4 and 8 close a round: one per-shard all-reduce of the
            # rank's rows, over the worker group of its shard column
            assert res[name]["sync"] == [{"state": {"pod+data": {
                "calls": 1, "bytes": rows // shards * 256 * 4,
                "async": 0}}}] * 2


def test_hier_row_shards_match_one_process(tmp_path):
    _spawn(SR.hier_rows, 4, str(tmp_path / "store"), str(tmp_path / "h"))
    ranks = _load(str(tmp_path / "h"), 4)
    et, st, _ = SR.hier_engine()
    for r in range(4):
        gk = MR.round_grads(et.spec.rows, et.spec.lanes, et.spec.size, 3, r,
                            2)
        st = et.round_step_flat(st, torch.from_numpy(np.ascontiguousarray(
            gk.reshape(2, *st.params.shape))))
    one = MR.buffers(st)
    for res in ranks:
        assert res["grid"] == {"pod": 1, "data": 2, "shard": 2}
        # (P, D) = (2, 2) over d_r = 2: each rank (2, 1) workers, half
        # the rows
        assert res["shape"] == [2, 1, et.spec.rows // 2, 256]
    mesh = ranks[0]["state"]
    assert sorted(mesh) == sorted(one)
    for f, v in one.items():
        scale = max(float(np.max(np.abs(v))), 1.0)
        np.testing.assert_allclose(mesh[f], v, rtol=0, atol=2e-6 * scale,
                                   err_msg=f)


def _fake_mesh(shape, axes=None):
    return coll.WorkerMesh(shape, 0, {}, axes)


@pytest.mark.parametrize("case", ["world", "axis size", "replicas",
                                  "clients"])
def test_row_shard_refusals(case, tmp_path):
    tpl = SR.template()
    if case == "world":
        with pytest.raises(ValueError, match="world % shards must be 0"):
            mesh_mod.rank_grid(4, 6, shards=4)
        with pytest.raises(ValueError, match=r"W % \(world / shards\)"):
            mesh_mod.rank_grid(3, 4, shards=2)
        assert mesh_mod.rank_grid(2, 4, shards=2) == (1, 2, 2)
        assert mesh_mod.rank_grid(4, 8, pods=2, shards=2) == (2, 2, 2)
    elif case == "axis size":
        with pytest.raises(ValueError, match="row-shard count must equal"):
            teng.make_engine(SR.port_shard_cfg(2), tpl,
                             mesh=_fake_mesh((1, 1, 4)))
    elif case == "replicas":
        with pytest.raises(ValueError, match="shard axis has 2 ranks"):
            teng.make_engine(SR.port_shard_cfg(1), tpl,
                             mesh=_fake_mesh((1, 2, 2)))
    else:
        # no longer refused: the client store on row shards runs, its
        # losses one process's (tests/test_torch_clients_shards.py holds
        # the store itself)
        argv = CLI + ["--workers", "2", "--clients", "4", "--steps", "2",
                      "--shards", "2"]
        _spawn(MR.cli, 2, _free_port(), argv + ["--mesh-grid"],
               str(tmp_path / "c"))
        one = t_launch.run(argv)
        for res in _load(str(tmp_path / "c"), 2):
            assert res["losses"] == one.losses and len(one.losses) == 2
            assert res["collectives"]["clients"]["pod+data"]["calls"] == 2


def test_engine_shard_axis_size_mismatch_fails_loudly():
    """``tests/test_engine_collectives.py::
    test_shard_axis_size_mismatch_fails_loudly`` on the port's rank grid:
    a shard axis of another size refuses, an absent (or size-1) axis and
    shards = 1 leave the rows layout only."""
    ecfg = EngineConfig(block=8, shards=4)
    bad = _fake_mesh((4, 2), ("data", "shard"))
    with pytest.raises(ValueError, match="shard"):
        tspecs.engine_shard_axis(bad, ecfg)
    good = _fake_mesh((2, 4), ("data", "shard"))
    assert tspecs.engine_shard_axis(good, ecfg) == "shard"
    assert tspecs.engine_shard_axis(_fake_mesh((8,), ("data",)),
                                    ecfg) is None
    assert tspecs.engine_shard_axis(good, EngineConfig(shards=1)) is None
    assert tspecs.engine_shard_axis(None, ecfg) is None


CLI = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--batch", "2",
       "--seq", "32", "--lr", "0.05", "--k", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _arrays(path: str) -> dict:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _cli_matches_one_process(tmp_path, workers: int) -> tuple:
    """world 2 = (data 1 × shard 2), ``workers`` W, --shards 2 with a save
    at step 4: the ranks' losses and the saved file bitwise one
    process's -> (argv, the mesh's and one process's checkpoint
    directories)."""
    argv = CLI + ["--workers", str(workers), "--shards", "2",
                  "--ckpt-every", "4"]
    mesh_ck, one_ck = str(tmp_path / "mesh"), str(tmp_path / "one")
    _spawn(MR.cli, 2, _free_port(), argv + ["--steps", "4", "--ckpt",
                                            mesh_ck, "--mesh-grid"],
           str(tmp_path / "a"))
    one = t_launch.run(argv + ["--steps", "4", "--ckpt", one_ck])
    ranks = _load(str(tmp_path / "a"), 2)
    for res in ranks:
        assert res["losses"] == one.losses
        assert res["avg"] == one.avg_model_losses
        st = res["collectives"]["state"]
        assert st == {"pod+data": {"calls": 2, "bytes": 2 * 1536 * 256 * 4,
                                   "async": 0}}
        assert res["collectives"]["forward"]["shard"]["calls"] == 4
    step = os.path.join("ckpt-00000004")
    a, b = _arrays(os.path.join(mesh_ck, step)), _arrays(
        os.path.join(one_ck, step))
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    with open(os.path.join(mesh_ck, step, "meta.json")) as f:
        assert json.load(f)["meta"]["flat_spec"]["shards"] == 2
    return argv, mesh_ck, one_ck


def test_cli_one_worker_a_rank_matches_one_process(tmp_path):
    """W = 1: each rank's rows of the gradient are one contiguous block,
    which the train loop takes as a view (two workers a rank copy it)."""
    _cli_matches_one_process(tmp_path, 1)


def test_cli_row_shards_match_one_process_save_and_resume(tmp_path):
    """world 2 = (data 1 × shard 2), W = 2, --shards 2 with a save at step
    4; then both resume to step 6."""
    argv, mesh_ck, one_ck = _cli_matches_one_process(tmp_path, 2)
    _spawn(MR.cli, 2, _free_port(), argv + ["--steps", "6", "--ckpt",
                                            mesh_ck, "--resume", "auto",
                                            "--mesh-grid"],
           str(tmp_path / "b"))
    one_r = t_launch.run(argv + ["--steps", "6", "--ckpt", one_ck,
                                 "--resume", "auto"])
    for res in _load(str(tmp_path / "b"), 2):
        assert res["losses"] == one_r.losses and len(one_r.losses) == 2
        assert res["avg"] == one_r.avg_model_losses
