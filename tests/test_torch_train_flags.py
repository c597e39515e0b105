"""PyTorch port, the training CLI's further flags and the refusals of a
codec architecture (``launch.train``, ``launch.serve``), on the CPU.

* ``--no-round`` (step by step through ``train_step``) is bitwise the
  round-by-round run: every step's loss and the final params and Δ, for
  vrl_sgd with the warm-up and a tail, hier_vrl_sgd, stl_sgd's schedule
  and the per-leaf executor; it refuses ``--overlap`` and
  ``--profile-round``, as the reference's does.
* ``--shards 4`` is bitwise ``--shards 1`` under sgd (layout only: the
  rows pad to a multiple of block · shards); ``--shards 2 --mesh-grid``
  is refused before any process group is joined.
* ``--profile-dir`` writes the ``--profile-round`` round's trace as
  Chrome-trace JSON; without it the round's table is printed as before.
* ``--layers N`` cuts the depth at the architecture's width: the engine's
  layout is the N-layer tree's, not the full depth's, and the banner says
  so.
* Both CLIs refuse musicgen-large (frame embeddings, not token ids) with
  a message that says what runs it; the full-width CLI trains with remat,
  ``--smoke`` without, as the reference's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402

BASE = ["--smoke", "--device", "cpu", "--workers", "2", "--steps", "7",
        "--k", "2", "--batch", "2", "--seq", "16", "--lr", "0.05",
        "--log-every", "100"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NO_ROUND_CASES = {
    "vrl_sgd_warmup": ["--warmup"],
    "bvr_l_sgd": ["--algorithm", "bvr_l_sgd"],
    "stl_sgd": ["--algorithm", "stl_sgd", "--k", "4"],
    "hier": ["--algorithm", "hier_vrl_sgd", "--workers", "4", "--pods",
             "2", "--k1", "2", "--k2", "4"],
    "reference": ["--backend", "reference", "--warmup"],
    "gemma": ["--arch", "gemma-7b", "--warmup"],
}


def _tensors(x):
    """Every tensor of a state (NamedTuples, dicts, tensors; () absent)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _same_state(a, b):
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) > 0 and all(map(torch.equal, ta, tb))


@pytest.mark.parametrize("case", sorted(NO_ROUND_CASES))
def test_no_round_is_bitwise_the_round_run(case, capsys):
    argv = BASE + NO_ROUND_CASES[case]
    rounds = t_launch.run(argv)
    steps = t_launch.run(argv + ["--no-round"])
    out = capsys.readouterr().out
    assert "round_scan=False" in out and "(step by step)" in out
    assert steps.losses == rounds.losses and len(steps.losses) == 7
    assert _same_state(steps.state, rounds.state)
    if case != "hier":
        assert (steps.state.step, steps.state.last_sync) == \
            (rounds.state.step, rounds.state.last_sync)


def test_no_round_logs_every_step_and_refuses_round_options(capsys):
    t_launch.run(BASE + ["--no-round", "--log-every", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [l.split()[1] for l in out if l.startswith("step")] == \
        ["1", "3", "6", "7"]
    for bad, why in ((["--overlap"], "--overlap"),
                     (["--profile-round", "1"], "--profile-round")):
        with pytest.raises(SystemExit, match=why):
            t_launch.run(BASE + ["--no-round"] + bad)


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_are_layout_only(shards, capsys):
    one = t_launch.run(BASE + ["--warmup"])
    many = t_launch.run(BASE + ["--warmup", "--shards", str(shards)])
    out = capsys.readouterr().out
    assert f"shards={shards} (layout only" in out
    es1, es = one.engine.spec, many.engine.spec
    assert es.size == es1.size and es.rows % (es.block * shards) == 0
    assert many.losses == one.losses
    n = es1.size
    assert torch.equal(many.state.params.reshape(2, -1)[:, :n],
                       one.state.params.reshape(2, -1)[:, :n])
    assert torch.equal(many.state.delta.reshape(2, -1)[:, :n],
                       one.state.delta.reshape(2, -1)[:, :n])


def test_shards_refused_with_mesh_grid():
    for bad, why in ((["--shards", "2", "--mesh-grid"], "--mesh-grid"),
                     (["--shards", "0"], ">= 1")):
        with pytest.raises(SystemExit, match=why):
            t_launch.run(BASE + bad)


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    t_launch.run(BASE + ["--steps", "4", "--profile-round", "2",
                         "--profile-dir", str(trace_dir)])
    out = capsys.readouterr().out
    assert "profile: round of 2 steps" in out
    path = trace_dir / "round_trace.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("cli", [t_launch, t_serve])
def test_clis_refuse_a_codec_architecture(cli):
    argv = ["--arch", "musicgen-large", "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit, match="takes frame embeddings") as e:
        cli.run(argv)
    assert "transformer.prefill/decode_step and make_train_step" in str(
        e.value)


@pytest.mark.parametrize("arch", ["stablelm-3b", "chameleon-34b"])
def test_new_archs_run_through_both_clis(arch, capsys):
    res = t_launch.run(BASE + ["--arch", arch, "--steps", "3"])
    assert np.all(np.isfinite(res.losses))
    served = t_serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert tuple(served.out.shape) == (2, 12)
    out = capsys.readouterr().out
    assert f"arch: {arch}" in out and "remat=False" in out


@pytest.mark.parametrize("arch,layers", [("qwen2-0.5b", 3),
                                         ("hymba-1.5b", 1)])
def test_layers_cuts_the_depth(arch, layers, capsys):
    import dataclasses

    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.models import param as tparam
    from repro_torch.models import transformer as T
    res = t_launch.run(BASE + ["--arch", arch, "--steps", "2", "--layers",
                               str(layers)])
    assert f"[depth cut to {layers} layers]" in capsys.readouterr().out
    cfg = dataclasses.replace(registry.smoke_arch(arch), num_layers=layers)
    n = sum(x.numel() for x in tm.leaves(tparam.abstract(T.model_defs(cfg))))
    assert res.engine.spec.size == n
    assert res.engine.spec.size != t_launch.run(
        BASE + ["--arch", arch, "--steps", "2"]).engine.spec.size
    assert np.all(np.isfinite(res.losses))
