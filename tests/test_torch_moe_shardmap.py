"""PyTorch port: the shard-mapped MoE dispatch
(``repro_torch.models.moe_shardmap``) over a (data, model) rank grid
against the JAX package.

The reference test's case (``tests/test_moe_shardmap.py``: smoke
phi3.5-moe, 8 experts top-2, capacity factor 8, no shared experts, 64
tokens) on gloo grids of world 4 (data 2 × model 2) and world 8 (data 2 ×
model 4):

* the output rows within 1e-5 of JAX's ``moe_mlp`` over the 64 tokens and
  of JAX's ``moe_mlp_shardmap`` on a (2, M) mesh of placeholder devices (a
  subprocess with ``--xla_force_host_platform_device_count``); the aux
  loss, a mean over the data blocks, within 1e-5 of the latter's;
* the gradients of Σ y · cot + 0.3 · aux with respect to x (summed over
  the model ranks) and to each rank's expert weight blocks within 1e-5 of
  ``jax.grad`` of the reference: ``moe_mlp``'s output (the capacity does
  not bind, so it is the shard-mapped layer's function) plus the aux mean
  over the data blocks of ``moe.route``;
* a forward and backward bitwise run to run;
* the collectives of a call: three weight gathers and the aux mean over
  "data", one output sum over "model".

Ranks run ``tests/torch_shard_ranks.py``'s ``moe_ranks``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_shard_ranks as SR  # noqa: E402

WORLDS = (4, 8)
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WEIGHTS = ("w_gate", "w_up", "w_down")

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.configs import registry
    from repro.models import moe as moe_ref
    from repro.models.moe_shardmap import moe_mlp_shardmap

    N, AUX = %d, %r
    cfg = registry.smoke_arch("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(cfg, num_experts=8, experts_per_token=2,
                              capacity_factor=8.0, num_shared_experts=0)
    inp = dict(np.load(sys.argv[1]))
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up",
                                          "w_down")}
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    mesh = compat.make_mesh((2, N // 2), ("data", "model"),
                            devices=jax.devices())
    y_ref, _ = moe_ref.moe_mlp(cfg, p, x)

    def ref_loss(p, x):
        y, _ = moe_ref.moe_mlp(cfg, p, x)
        auxes = [moe_ref.route(cfg, p["router"], xb)[2]
                 for xb in jnp.split(x, 2)]
        return jnp.sum(y * cot) + AUX * (sum(auxes) / 2)

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(p, x)
    with compat.set_mesh(mesh):
        y_sm, aux_sm = jax.jit(
            lambda p, x: moe_mlp_shardmap(cfg, p, x, mesh))(p, x)
    np.savez(sys.argv[2], y_ref=np.asarray(y_ref), y_sm=np.asarray(y_sm),
             aux_sm=np.asarray(aux_sm), gx=np.asarray(gx),
             **{"g_" + k: np.asarray(gp[k]) for k in
                ("w_gate", "w_up", "w_down")})
""")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses (started first) and the port's ranks at each
    world."""
    d = tmp_path_factory.mktemp("moe")
    np.savez(d / "inputs.npz", **SR.moe_inputs(SR.moe_cfg()))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % (n, n, SR.AUX_WEIGHT),
         str(d / "inputs.npz"), str(d / f"jax{n}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in WORLDS}
    port = {}
    for n in WORLDS:
        tmp.start_processes(SR.moe_ranks, args=(n, str(d / f"store{n}"),
                                                str(d / f"port{n}")),
                            nprocs=n, start_method="spawn")
        port[n] = [torch.load(f"{d}/port{n}.rank{r}", weights_only=False)
                   for r in range(n)]
    ref = {}
    for n, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        ref[n] = dict(np.load(d / f"jax{n}.npz"))
    return {"port": port, "jax": ref,
            "inputs": dict(np.load(d / "inputs.npz"))}


def _rows(x: np.ndarray, j: int) -> np.ndarray:
    n = x.shape[0] // 2
    return x[j * n:(j + 1) * n]


def _block(w: np.ndarray, name: str, j: int, i: int, m: int) -> np.ndarray:
    """Rank (data j, model i)'s block of a whole expert weight."""
    dim = 2 if name == "w_down" else 1
    e, n = w.shape[0] // m, w.shape[dim] // 2
    return np.take(w[i * e:(i + 1) * e], np.arange(j * n, (j + 1) * n),
                   axis=dim)


@pytest.mark.parametrize("world", WORLDS)
def test_output_matches_jax_moe_mlp_and_shardmap(runs, world):
    ref = runs["jax"][world]
    assert float(np.max(np.abs(ref["y_sm"] - ref["y_ref"]))) < 1e-4
    for res in runs["port"][world]:
        j, _ = res["coords"]
        y = res["runs"][0]["y"]
        np.testing.assert_allclose(y, _rows(ref["y_ref"], j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(y, _rows(ref["y_sm"], j), rtol=0,
                                   atol=1e-5)
        assert abs(res["runs"][0]["aux"] - float(ref["aux_sm"])) <= 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_match_jax_grad_of_the_reference(runs, world):
    ref = runs["jax"][world]
    m = world // 2
    for res in runs["port"][world]:
        j, i = res["coords"]
        out = res["runs"][0]
        np.testing.assert_allclose(out["gx"], _rows(ref["gx"], j), rtol=0,
                                   atol=1e-5)
        for k in WEIGHTS:
            np.testing.assert_allclose(
                out["gw"][k], _block(ref["g_" + k], k, j, i, m), rtol=0,
                atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_bitwise_run_to_run(runs, world):
    for res in runs["port"][world]:
        a, b = res["runs"]
        for k in ("y", "gx"):
            assert np.array_equal(a[k], b[k]), k
        assert a["aux"] == b["aux"]
        for k in WEIGHTS:
            assert np.array_equal(a["gw"][k], b["gw"][k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_of_a_call(runs, world):
    m = world // 2
    cfg = SR.moe_cfg()
    d, ff = cfg.d_model, cfg.moe_d_ff
    block = cfg.num_experts // m * (d // 2) * ff * 4      # one weight block
    for res in runs["port"][world]:
        counts = res["runs"][0]["counts"]
        assert counts == {"moe": {
            "data": {"calls": 4, "bytes": 3 * block + 4, "async": 0},
            "model": {"calls": 1, "bytes": SR.MOE_TOKENS // 2 * d * 4,
                      "async": 0}}}, json.dumps(counts)


def test_layer_refuses_shared_experts():
    import dataclasses

    from repro_torch.comm import collectives as coll
    from repro_torch.models import moe_shardmap as ms
    cfg = dataclasses.replace(SR.moe_cfg(), num_shared_experts=1)
    mesh = coll.WorkerMesh((1, 1), 0, {}, ("data", "model"))
    with pytest.raises(ValueError, match="shared experts"):
        ms.moe_mlp_shardmap(cfg, {}, torch.zeros(4, cfg.d_model), mesh)


def test_shard_params_cuts_the_reference_blocks():
    """``shard_params`` / ``shard_tokens``: each rank's blocks, the router
    whole (the reference's in_specs)."""
    from repro_torch.comm import collectives as coll
    from repro_torch.models import moe_shardmap as ms
    inp = SR.moe_inputs(SR.moe_cfg())
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for rank in range(8):
        mesh = coll.WorkerMesh((2, 4), rank, {}, ("data", "model"))
        j, i = mesh.coords
        blocks = ms.shard_params(t, mesh)
        assert blocks["router"] is t["router"]
        for k in WEIGHTS:
            assert np.array_equal(blocks[k].numpy(),
                                  _block(inp[k], k, j, i, 4)), k
        assert np.array_equal(ms.shard_tokens(t["x"], mesh).numpy(),
                              _rows(inp["x"], j))
