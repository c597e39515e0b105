"""State checkpointing (``repro.checkpoint.checkpoint``): flattened-key npz
plus json metadata, the JAX package's file format.

A state is flattened to one npz entry per leaf under the key the JAX
package writes for it (``tree.state_leaves``: "params", "delta",
"inner/mu", "inner/nu/row", "comm/resid", "overlap/pend_k", ...); on
restore the structure comes from a template state and every leaf is
looked up by its key, so a checkpoint written by either package restores
in the other.  Empty fields (``()``, ``None``) hold no entry.  Host
integers (the step counters, Adam's count) are written as 0-d int32
arrays, as the JAX package holds them, and read back as ints.  bfloat16
leaves, which numpy cannot name, are written as their 16-bit patterns
viewed as the void dtype ``V2`` with "bfloat16" recorded in ``dtypes`` —
how the JAX package's bf16 arrays reach the file — and read back to
``torch.bfloat16`` bit for bit.  ``treedef`` holds the port's own
description of the state; nothing reads it back.

Atomicity
---------

A checkpoint is ONE file: ``arrays.npz`` with the json metadata embedded as
a ``__meta__`` uint8 entry.  ``save`` writes a temp file in the same
directory, one leaf at a time (each staged to the host alone), fsyncs, and
``os.replace``s it over the final name — the rename is the commit point,
so a process killed mid-save (for real, or via :func:`kill_save`) leaves
either the previous complete checkpoint or a stale ``arrays.npz.tmp.*``
that the next save sweeps up; never a torn ``arrays.npz``.  A sidecar
``meta.json`` is still written (best-effort, after the commit) for human
inspection, and ``load_meta`` falls back to it.

Step-dir layout (``save_step`` / ``latest_step``): a run's checkpoint root
holds ``ckpt-XXXXXXXX/`` per saved step plus an atomically-updated
``latest`` pointer file; ``retain`` prunes all but the newest N step dirs.
``--resume auto`` resolves through ``latest_step`` and survives a lost or
stale pointer by falling back to a directory scan.

A restore places every leaf on its template leaf's device, as a new
tensor, and refuses a shape or dtype that differs from the template's.
On a mesh each rank takes its block of every leaf (``Block``).
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import struct
import zipfile
import zlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod

SEP = "/"
META_KEY = "__meta__"
LATEST = "latest"
BF16 = "bfloat16"


class SimulatedKill(RuntimeError):
    """Raised by a save under ``kill_save`` — stands in for SIGKILL at the
    worst moment of a checkpoint write (tests and the chaos harness catch
    it where a real kill would need a process restart)."""


_KILL = {"phase": None}


@contextlib.contextmanager
def kill_save(phase: str = "mid-write"):
    """Arm a one-shot simulated kill inside the next ``save``.

    ``phase="mid-write"``: the temp file is torn (truncated to half its
    bytes) and ``SimulatedKill`` raises BEFORE the commit rename — the
    published ``arrays.npz`` must be untouched.
    ``phase="pre-rename"``: the temp file is complete but the rename never
    happens — the checkpoint still must not be considered written.
    """
    if phase not in ("mid-write", "pre-rename"):
        raise ValueError(f"unknown kill_save phase {phase!r}")
    prev = _KILL["phase"]
    _KILL["phase"] = phase
    try:
        yield
    finally:
        _KILL["phase"] = prev


def _maybe_kill(phase: str, tmp: str | None = None) -> None:
    if _KILL["phase"] != phase:
        return
    _KILL["phase"] = None                      # one-shot: a kill fires once
    if phase == "mid-write" and tmp is not None:
        size = os.path.getsize(tmp)
        with open(tmp, "r+b") as f:
            f.truncate(max(size // 2, 1))
    raise SimulatedKill(f"simulated kill during checkpoint save ({phase})")


class Block(NamedTuple):
    """This rank's part of a checkpoint on a mesh: ``take(key, full)`` cuts
    this rank's block out of a saved (full) leaf, ``full_shape(key,
    shape)`` the full shape of a leaf this rank holds at ``shape``
    (``launch.mesh.state_block`` builds it)."""

    take: Callable[[str, np.ndarray], np.ndarray]
    full_shape: Callable[[str, tuple], tuple]


# ------------------------------------------------------------ leaf codecs
def _leaf_info(leaf: Any) -> tuple:
    """(shape, recorded dtype string) of a leaf, read without a copy."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).replace("torch.", "")
        return tuple(leaf.shape), name
    if isinstance(leaf, (bool, np.bool_)) or not isinstance(
            leaf, (int, np.integer, np.ndarray)):
        raise TypeError(f"cannot checkpoint a leaf of type "
                        f"{type(leaf).__name__}")
    if isinstance(leaf, np.ndarray):
        return leaf.shape, str(leaf.dtype)
    return (), "int32"


def _to_host(leaf: Any) -> np.ndarray:
    """One leaf as the array the file holds (bf16 as its bits viewed as
    V2; a host integer as a 0-d int32)."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
        return x.cpu().numpy()
    if isinstance(leaf, np.ndarray):
        return leaf
    return np.asarray(int(leaf), np.int32)


def _as_bf16_bits(arr: np.ndarray, rec: Optional[str]) -> bool:
    return rec == BF16 and arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _from_file(arr: np.ndarray, rec: Optional[str]):
    """A loaded entry with its recorded dtype: extension dtypes (bfloat16)
    survive npz as raw void bytes and stay so here (``_to_tensor`` re-views
    them, bitwise)."""
    if arr.dtype.kind == "V" and rec is not None and not _as_bf16_bits(
            arr, rec):
        arr = arr.view(np.dtype(rec))
    return arr


def _to_tensor(arr: np.ndarray, rec: Optional[str]) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if _as_bf16_bits(arr, rec):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place(key: str, arr: np.ndarray, rec: Optional[str], leaf: Any) -> Any:
    """The restored leaf for template ``leaf``: a new tensor on the
    template's device (shape and dtype must match), or an int."""
    shape, dt = _leaf_info(leaf)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} != template "
                         f"{tuple(shape)}")
    got_dt = rec if rec is not None else str(arr.dtype)
    if not isinstance(leaf, torch.Tensor):
        if arr.dtype.kind not in "iu":
            raise ValueError(f"{key}: dtype {got_dt} where the template "
                             f"holds an integer")
        return int(arr)
    if got_dt != dt:
        raise ValueError(f"{key}: dtype {got_dt} != template {dt}")
    return _to_tensor(arr, rec).to(leaf.device)


def _describe(tree: Any) -> str:
    """The port's description of a state's structure (``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_describe(getattr(tree, f))}"
                            for f in tree._fields) + ")")
    if isinstance(tree, (tuple, list)):
        body = ", ".join(_describe(v) for v in tree)
        return f"({body})" if isinstance(tree, tuple) else f"[{body}]"
    return "*"


def _write_entry(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """One stored ``key.npy`` entry, as ``np.savez`` writes it: the npy
    header, then the array's bytes in one write (no chunked copy)."""
    if not arr.flags.c_contiguous:      # (np.ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array_header_1_0(
            fid, np.lib.format.header_data_from_array_1_0(arr))
        fid.write(memoryview(arr.reshape(-1).view(np.uint8)))


class ArrayFile:
    """The entries of an ``arrays.npz`` by key (``key in f``, ``f[key]``,
    ``f.files``).  A stored entry is read straight from its offset in the
    file into one array, its CRC-32 checked as ``zipfile`` checks it; a
    compressed one goes through ``np.lib.format.read_array``.  Either way
    the array is the one ``np.load`` returns."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._zf = zipfile.ZipFile(self._f)
        self.files = [n[:-4] for n in self._zf.namelist()
                      if n.endswith(".npy")]

    def __contains__(self, key: str) -> bool:
        return key + ".npy" in self._zf.NameToInfo

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zf.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zf.open(info) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        f = self._f
        f.seek(info.header_offset)
        local = f.read(30)                      # the local file header
        start = (info.header_offset + 30
                 + sum(struct.unpack("<HH", local[26:30])))
        f.seek(start)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(
                           np.lib.format.read_magic(f))
        shape, fortran, dtype = (read_header(f) if read_header else
                                 ((), False, np.dtype(object)))
        head = f.tell() - start
        count = int(np.prod(shape, dtype=np.int64))
        if dtype.hasobject or head + count * dtype.itemsize \
                != info.file_size:
            with self._zf.open(info) as g:
                return np.lib.format.read_array(g, allow_pickle=False)
        arr = np.fromfile(f, dtype=dtype, count=count)
        f.seek(start)
        crc = zlib.crc32(arr.view(np.uint8), zlib.crc32(f.read(head)))
        if crc != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
        return arr.reshape(shape, order="F" if fortran else "C")

    def close(self) -> None:
        self._zf.close()
        self._f.close()

    def __enter__(self) -> "ArrayFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------ save/restore
def save(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree`` (a state of tensors, host ints and nested
    containers) to ``path/arrays.npz`` atomically, one leaf on the host
    at a time."""
    os.makedirs(path, exist_ok=True)
    leaves = tree_mod.state_leaves(tree)
    keys = [k for k, _ in leaves]
    if META_KEY in keys:
        raise ValueError(f"tree key {META_KEY!r} collides with the "
                         f"embedded-metadata entry")
    infos = {k: _leaf_info(v) for k, v in leaves}
    info = {
        "keys": keys,
        "treedef": "repro_torch " + _describe(tree),
        "meta": meta or {},
        "shapes": {k: list(s) for k, (s, _) in infos.items()},
        "dtypes": {k: d for k, (_, d) in infos.items()},
    }
    payload = np.frombuffer(json.dumps(info).encode("utf-8"), np.uint8)
    final = os.path.join(path, "arrays.npz")
    # sweep temp files orphaned by a previous kill — they were never
    # published, so they are garbage by construction
    for stale in glob.glob(final + ".tmp.*"):
        with contextlib.suppress(OSError):
            os.remove(stale)
    tmp = f"{final}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            _write_entry(zf, META_KEY, payload)
            for key, leaf in leaves:
                _write_entry(zf, key, _to_host(leaf))
        f.flush()
        os.fsync(f.fileno())
    # a SimulatedKill here leaves the temp behind, like a real SIGKILL
    # would — the published arrays.npz is untouched either way
    _maybe_kill("mid-write", tmp)
    _maybe_kill("pre-rename")
    os.replace(tmp, final)                       # the commit point
    with contextlib.suppress(OSError):           # sidecar: human-readable,
        with open(os.path.join(path, "meta.json"), "w") as f:  # best-effort
            json.dump(info, f, indent=1)


def restore(path: str, like: Any, *, block: Optional[Block] = None) -> Any:
    """Restore into the structure of ``like`` (a template state): every
    leaf a new tensor on its template leaf's device.  ``block``: on a
    mesh, this rank's part of every leaf."""
    dtypes = load_meta(path).get("dtypes", {})
    with ArrayFile(os.path.join(path, "arrays.npz")) as data:
        def one(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            rec = dtypes.get(key)
            arr = _from_file(data[key], rec)
            if block is None:
                return _place(key, arr, rec, leaf)
            full = block.full_shape(key, _leaf_info(leaf)[0])
            if tuple(arr.shape) != tuple(full):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                                 f"template {tuple(full)}")
            return _place(key, block.take(key, arr), rec, leaf)
        return tree_mod.state_map(one, like)


def load_meta(path: str) -> dict:
    """Checkpoint metadata — embedded ``__meta__`` npz entry first (the
    atomic format), sidecar ``meta.json`` as the legacy fallback."""
    npz = os.path.join(path, "arrays.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            if META_KEY in data:
                return json.loads(bytes(data[META_KEY]).decode("utf-8"))
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


# ------------------------------------------------------- step-dir layout

def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"ckpt-{step:08d}")


def _write_latest(root: str, name: str) -> None:
    tmp = os.path.join(root, f".latest.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, LATEST))


def _complete(root: str, name: str) -> bool:
    return os.path.exists(os.path.join(root, name, "arrays.npz"))


def save_step(root: str, step: int, save_fn: Callable[[str], None],
              *, retain: int = 0) -> str:
    """Write one checkpoint under the step-dir layout.

    ``save_fn(path)`` does the actual write (``save`` /
    ``save_flat_state`` bound to the run's state) into the step dir;
    only after it returns is the ``latest`` pointer flipped — a save
    killed mid-write leaves the pointer on the previous good step.
    ``retain > 0`` then prunes all but the newest ``retain`` step dirs
    (the one just written always survives).
    """
    os.makedirs(root, exist_ok=True)
    d = step_dir(root, step)
    save_fn(d)
    _write_latest(root, os.path.basename(d))
    if retain > 0:
        _prune(root, retain)
    return d


def latest_step(root: str) -> Optional[tuple[int, str]]:
    """(step, path) of the newest COMPLETE checkpoint under ``root``, or
    None.  Trusts the ``latest`` pointer when it names a complete step
    dir; otherwise (pointer lost, stale, or torn) falls back to scanning
    the step dirs."""
    if not os.path.isdir(root):
        return None
    name = None
    lf = os.path.join(root, LATEST)
    if os.path.exists(lf):
        with open(lf) as f:
            cand = f.read().strip()
        if cand and _complete(root, cand):
            name = cand
    if name is None:
        steps = sorted(d for d in os.listdir(root)
                       if d.startswith("ckpt-") and _complete(root, d))
        if not steps:
            return None
        name = steps[-1]
    return int(name.rsplit("-", 1)[1]), os.path.join(root, name)


def _prune(root: str, retain: int) -> None:
    steps = sorted(d for d in os.listdir(root) if d.startswith("ckpt-"))
    for name in steps[:-retain]:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)


# ----------------------------------------------------- flat-engine states
# The flat engine's FlatWorkerState / HierFlatState is an ordinary state
# of buffers, so save()/restore() work unchanged — but a flat buffer is
# meaningless without its unravel spec (leaf paths/shapes/offsets +
# tiling), and a pod-major hierarchical buffer additionally without its
# (P, D) worker grid.  These helpers persist both alongside the arrays and
# refuse to restore into an engine whose layout disagrees (e.g. different
# lane width, model revision, block auto-choice, or pod grid).

def _carries_comm(state: Any) -> bool:
    """True when the state carries compressed-sync buffers (a non-empty
    ``comm`` field)."""
    return len(tree_mod.state_leaves(getattr(state, "comm", ()))) > 0


def moments_meta(cfg) -> dict:
    """JSON-safe moment-storage description of a VRLConfig: what dtype the
    inner-optimizer moments persist at and whether Adam's second moment is
    SM3-factored.  Recorded at save and validated at restore — bf16 / SM3
    buffers restored into an fp32 engine (or vice versa) would silently
    reinterpret state."""
    return {"moment_dtype": getattr(cfg, "moment_dtype", "float32"),
            "sm3": bool(getattr(cfg, "sm3", False))}


def save_flat_state(path: str, state: Any, spec, meta: dict | None = None,
                    grid=None, compressors: dict | None = None,
                    moments: dict | None = None) -> None:
    """Save a flat-engine state plus its flat.FlatSpec layout.

    ``grid``: the pod-major (P, D) worker grid for hierarchical states
    (``engine.Engine.grid``); omit for flat (W, R, C) states.
    ``compressors``: per-level sync-compressor metadata
    (``repro_torch.comm.pair_meta``) — recorded (None for uncompressed) so
    a restore into a differently-compressed engine fails loudly instead of
    silently dropping or misreading the error-feedback residual buffers.
    ``moments``: moment-storage metadata (``moments_meta(cfg)``) — same
    loud-failure contract for bf16/SM3 moment buffers.  The shard layout
    needs no extra field: ``spec.meta()`` carries ``shards`` and a
    mismatch fails the flat_spec comparison.
    """
    if compressors is None and _carries_comm(state):
        raise ValueError(
            "state carries compressed-sync buffers (comm.resid/ref) but no "
            "compressor metadata was given — pass compressors=repro_torch."
            "comm.pair_meta(engine.compressors) so a restore can validate "
            "them")
    m = dict(meta or {})
    m["flat_spec"] = spec.meta()
    m["compressors"] = compressors
    if moments is not None:
        m["moments"] = moments
    if grid is not None:
        m["worker_grid"] = [int(g) for g in grid]
    save(path, state, meta=m)


def restore_flat_state(path: str, state_like: Any, spec, grid=None,
                       compressors: dict | None = None,
                       moments: dict | None = None, *,
                       block: Optional[Block] = None) -> Any:
    """Restore a flat-engine state, validating the recorded unravel spec
    (and, for hierarchical states, the recorded (P, D) worker grid, the
    recorded per-level sync compressors, and the recorded moment storage).

    A compressor mismatch is a hard error: the compressed-sync residuals
    (and drift references) in the checkpoint only mean anything to an
    engine running the SAME compressors — restoring them elsewhere would
    silently drop the carried error feedback or corrupt the next sync.
    Shard-count and moment-dtype/SM3 mismatches fail the same way (the
    shard count rides in ``spec.meta()``; moments in the ``moments``
    record when the saver provided one).  ``block``: on a mesh, this
    rank's block of every leaf.
    """
    if compressors is None and _carries_comm(state_like):
        raise ValueError(
            "restore target carries compressed-sync buffers (comm.resid/"
            "ref) but no compressor metadata was given — pass compressors="
            "repro_torch.comm.pair_meta(engine.compressors) so the "
            "recorded compressors can be validated")
    recorded = load_meta(path)["meta"]
    validate_flat_meta(recorded, spec, compressors=compressors,
                       moments=moments, grid=grid)
    return restore(path, state_like, block=block)


def validate_flat_meta(recorded: dict, spec, *, compressors=None,
                       moments=None, grid=None) -> None:
    """The restore-compatibility gate shared by ``restore_flat_state``
    and the resharding restore: layout spec, sync compressors, moment
    storage and (hierarchical) worker grid must all match the target
    engine, each failing with a message naming the field and both
    values."""
    rec_spec = recorded.get("flat_spec")
    if rec_spec is not None and rec_spec != spec.meta():
        raise ValueError(
            "checkpoint flat-buffer layout does not match the engine's "
            f"unravel spec:\n  checkpoint: {rec_spec}\n  engine:     "
            f"{spec.meta()}")
    rec_comp = recorded.get("compressors")
    if rec_comp != compressors:
        raise ValueError(
            "checkpoint sync compressors do not match the engine's — "
            "refusing to restore (the error-feedback residuals would be "
            f"dropped or misread):\n  checkpoint: {rec_comp}\n"
            f"  engine:     {compressors}")
    rec_mom = recorded.get("moments")
    if rec_mom is not None and moments is not None and rec_mom != moments:
        raise ValueError(
            "checkpoint moment storage does not match the engine's — "
            "refusing to restore (bf16/SM3 moment buffers would be "
            f"reinterpreted):\n  checkpoint: {rec_mom}\n"
            f"  engine:     {moments}")
    rec_grid = recorded.get("worker_grid")
    if (rec_grid is not None and grid is not None
            and [int(g) for g in grid] != rec_grid):
        raise ValueError(
            f"checkpoint worker grid {rec_grid} does not match the "
            f"engine's grid {list(grid)}")
