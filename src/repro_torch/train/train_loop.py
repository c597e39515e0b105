"""Train-step factory (``repro.train.train_loop``, engine branch).

``make_train_step`` binds (model config, algorithm config) into functions
over worker-stacked engine state:

  train_step(state, tokens, labels) -> (state, loss)
      one local iteration + the sync when a period completes
  local_step(state, tokens, labels) -> (state, loss)
      local iteration only
  sync_step(state) -> state
      model averaging + Δ update (the per-period communication event;
      hier_vrl_sgd: sync1 then sync2, and ``sync1_step``/``sync2_step``
      run one level)
  round_step(state, tokens_k, labels_k) -> (state, losses)
      ONE COMMUNICATION ROUND: k local steps over (k, W, ...) token/label
      stacks, then the round-closing sync (a no-op for S-SGD, which
      averages gradients every step; hier_vrl_sgd: sync1 plus sync2 when
      the k2 cadence is due); losses stay on the device as a (k,) tensor.
      The caller sizes each round: k=1 for VRL-SGD-W's warmup round, the
      stage's k under a CommSchedule, k1 for the hierarchy
      (``launch/train.py``).  Under ``overlap`` the round opens with the
      engine's ``round_begin`` (the mean of the previous boundary's
      positions; hier: the cross-pod mean, when the round ends on the k2
      cadence) and closes with ``round_fold`` (the stale fold and the
      capture; hier: sync1, then the fold when due) instead.
  round_step_fault(state, tokens_k, labels_k, gmul) -> (state, losses)
      ``round_step`` with a (k, W) host multiplier of each step's and
      worker's gradient (1 = clean; NaN/Inf/a finite scale poisons that
      worker's step, after clipping, so the poison is not renormalised
      away) — the chaos harness's entry point (``repro_torch.fault``).
      All ones is bitwise ``round_step``.
  health(state, loss) -> bool
      the divergence guard's predicate: the loss finite and every ACTIVE
      worker's parameters finite (a dead worker's rows are not read).

Per-worker gradients: the reference ``vmap``s one forward/backward over
the worker axis; here a loop over workers runs each on views of
``params[w]`` (the engine's buffer, no copy), clips them to
``vrl_cfg.clip_norm`` when set (``clip_by_global_norm``, per worker) and
writes them into ONE reused (W, R, C) buffer, so W gradient trees are
never held at once.  Under ``vrl_cfg.membership`` the reported loss is
the mean over the ACTIVE workers (a dead worker's NaN loss must not poison
it, nor the guard reading it), bitwise the plain mean with all active.  For hier_vrl_sgd the workers are the pod-major grid's
(worker i is pod i // D, member i % D), and the engine sees the same
buffer as a (P, D, R, C) view, with no copy.
The update kernels then run over the whole buffer, after every backward
of the step has finished — they write ``params`` in place.  The reported
loss is the mean over workers.

On a row-sharded mesh (``EngineConfig.shards`` S over the mesh's shard
axis) the engine holds this rank's R/S rows of its workers' buffers:
before each step's forward the rows are gathered over the shard group
into a transient (W, R, C) buffer (``Engine.gather_params``, counted
"forward"), every shard rank runs the same forward and backward on it (the
batch is not split over the shard ranks, so the gradient sums in the
one-process order and each rank clips the whole gradient), and the
engine's update takes the rank's own rows of the gradient
(``Engine.own_rows``).

A worker over ranks (a mesh with an "fsdp" axis of F ranks, the
reference's FSDP axes; ``launch.mesh.make_engine_mesh(fsdp=)``): every fsdp rank holds its worker rank's whole
state and is given each of its workers' whole batch, as a row-shard rank
is; it runs the f-th of F contiguous slices of it along the batch dim
(rows [f·b/F, (f+1)·b/F), the reference's ``batch_sharding_spec``), with
the routed layers' dispatch and aux loss over the whole batch
(``models.moe``, the group passed to ``transformer.forward``).  The
backward does not clip: the gradient is first averaged over the fsdp
group (``comm.collectives.fsdp_mean``, counted "grad"; the slices are
equal, so the mean of the slice means is the batch mean), then clipped by
the worker's global norm.  On a row-sharded grid the mean covers only the
rank's own rows, and the norm is the whole worker's: one all-reduce of
the squared sums over the shard group ("grad"), so every rank of a worker
holds bitwise the same clipped rows.  The reported loss is the mean of
the fsdp ranks' slice losses (one "scalar" all-reduce over fsdp), then
the worker mean as below.  Where F does not divide the batch, every fsdp
rank runs the whole batch with no gradient mean, as the reference
replicates it.  Membership and the hierarchy are refused on such a grid
(``core.engine``), and so is the client store (``core.clients``).

On a mesh (``mesh=``, ``comm.collectives.WorkerMesh``; the reference's
``mesh`` with ``worker_axes=("pod", "data")``) the engine holds this
rank's block of the workers, ``grads_fn`` runs only those, and the
reported loss is the global worker mean, through all-reduces counted
apart from the model-state ones:
``round_step`` reduces its (k,) losses once, after the round's sync (so
no scalar joins the queue behind an overlapped mean in flight), the
per-step functions one scalar each.  The per-leaf executor stays
single-process and is refused on a mesh.

Backend selection: ``vrl_cfg.update_backend``, resolved for the device by
``core.engine.resolve_backend``.  "auto"/"fused" (and "xla" on the CPU)
build the flat-buffer engine above; "reference" runs the per-leaf
reference executor (``core.get_algorithm``) over tree-structured
``WorkerState`` / ``HierState``: the same per-worker forward/backward,
with the gradients written into a worker-stacked tree ((P, D, ...) leaves
for the hierarchy), then the algorithm's functional local step, and at the
round's end its sync (hierarchy: sync1, plus sync2 when the k2 cadence is
due).  It launches no kernel, has no ``engine`` (None), and refuses what
the reference's refuses there: overlapped rounds and membership.  Its
``round_step_fault`` and ``health`` are the reference's too (``--guard``
runs with ``--backend reference``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.comm import collectives as coll
from repro_torch.comm import compressors as comm_mod
from repro_torch.configs.base import ModelConfig, VRLConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core import flat
from repro_torch.core import get_algorithm
from repro_torch.core.types import MemberState
from repro_torch.kernels.torch_update import sqrt_rn
from repro_torch.launch.mesh import local_workers
from repro_torch.models import transformer
from repro_torch.models.param import abstract
from repro_torch.train.loss import chunked_cross_entropy_lm, cross_entropy_lm


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    """Per-worker global-norm clipping (``repro.train.train_loop``): scale
    every gradient by min(1, max_norm / max(‖g‖₂, 1e-9)), the norm taken
    over all leaves in fp32 and its root correctly rounded (``sqrt_rn``,
    as XLA's).  ``grads``: a tree (dict) or a sequence of tensors
    (returned as a list)."""
    gl = tree_mod.leaves(grads) if isinstance(grads, dict) else list(grads)
    gn = sqrt_rn(sum(torch.sum(torch.square(g.to(torch.float32)))
                     for g in gl))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def clip(g):
        return (g.to(torch.float32) * scale).to(g.dtype)
    if isinstance(grads, dict):
        return tree_mod.tree_map(clip, grads)
    return [clip(g) for g in gl]


class StepBundle(NamedTuple):
    init_state: Callable        # (seed, num_workers) -> state
    train_step: Callable
    local_step: Callable
    sync_step: Callable
    grads_fn: Callable          # (state, tokens, labels) -> (gbuf, loss)
    average_model: Any = None   # (state,) -> single-model tree
    engine: Any = None          # core.engine.Engine
    round_step: Any = None      # (state, tokens_k, labels_k) -> (state, losses)
    timer: Any = None           # PhaseTimer (None unless timing was asked)
    sync1_step: Any = None      # hier only: (state,) -> state, intra-pod
    sync2_step: Any = None      # hier only: (state,) -> state, cross-pod
    round_step_fault: Any = None  # (state, tokens_k, labels_k, gmul) ->
                                # (state, losses): round_step with a (k, W)
                                # numpy gradient multiplier
    health: Any = None          # (state, loss) -> bool: loss finite and
                                # every ACTIVE worker's params finite


class PhaseTimer:
    """Device time of the step's phases — ``fwd_bwd`` (per-worker forward
    and backward), ``local`` (the local-step kernel), ``sync`` (worker
    mean + sync kernel, after the EF round trip under compression; hier:
    sync1 plus sync2 when due), and under overlap ``round_begin`` (the
    worker mean over pend; hier: the cross-pod mean, when due) and
    ``fold`` (the fold and the capture; hier: sync1 plus the fold when
    due) — from CUDA events recorded around each,
    with no host sync while recording; ``ms()`` synchronises and reads
    them."""

    def __init__(self):
        self.events: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events.setdefault(name, []).append((start, end))

    def ms(self) -> dict:
        """{phase: [ms of each span, in order]}, for the phases that ran."""
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


def _worker_grads(loss_fn: Callable, clip_norm: float, ptree: Any,
                  gtree: Any, idx: tuple, tokens, labels) -> torch.Tensor:
    """One worker's forward/backward on the views ``x[idx]`` of the
    worker-stacked parameter tree; its gradients go into ``gtree``'s
    ``[idx]`` slices (clipped to ``clip_norm`` when set).  Returns the
    loss."""
    pairs = tree_mod.leaves_with_path(tree_mod.tree_map(lambda x: x[idx],
                                                        ptree))
    leaves = [x.detach().requires_grad_() for _, x in pairs]
    params = tree_mod.from_paths(
        [(path, x) for (path, _), x in zip(pairs, leaves)])
    loss = loss_fn(params, tokens, labels)
    # a leaf the loss does not read (the codec frontend's token ``embed``
    # under an untied head) gets a zero gradient, as under jax.grad
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    if clip_norm:
        grads = clip_by_global_norm(grads, clip_norm)
    with torch.no_grad():
        for gl, g in zip(tree_mod.leaves(gtree), grads):
            gl[idx].copy_(g)
    return loss.detach()


def _finite(x: torch.Tensor) -> bool:
    """All of ``x`` finite, read through max|x| (NaN and ±inf carry into
    it) without an elementwise temporary the size of ``x``."""
    return bool(torch.isfinite(torch.linalg.vector_norm(
        x.to(torch.float32), float("inf"))))


def _health(state, loss, mesh=None) -> bool:
    """The divergence guard's predicate over a state's parameters (a flat
    (W, R, C) or pod-major buffer, or the per-leaf executor's tree): the
    loss finite and every ACTIVE worker's parameters finite (with a
    ``MemberState`` the dead rows are not read).  On a mesh every rank's
    verdict, through one all-reduce counted "eval"."""
    ok = _finite(torch.as_tensor(loss))
    member = getattr(state, "member", ())
    if isinstance(state.params, torch.Tensor):
        p = state.params
        rows = p.view(-1, *p.shape[-2:])
        live = (engine_mod.host_mask(member).live
                if isinstance(member, MemberState) else range(rows.shape[0]))
        ok = ok and all(_finite(rows[i]) for i in live)
    else:
        ok = ok and all(_finite(x) for x in tree_mod.leaves(state.params))
    if mesh is None:
        return ok
    flag = torch.tensor(float(ok), device=coll.wire_device(mesh))
    mesh.all_reduce(flag, mesh.axes, kind="eval",
                    op=torch.distributed.ReduceOp.MIN)
    return bool(flag.item() > 0)


def _grad_mul(rows: torch.Tensor, size: int, m: np.ndarray) -> None:
    """Scale each worker's gradient row of ``rows`` ((n, R, C); the leaf
    spans are its first ``size`` elements, the pad stays zero) by its
    entry of ``m`` (n,), in place, as the reference multiplies the
    worker's gradient tree: NaN or Inf poisons the worker's local step;
    1 changes nothing and is skipped (g · 1 = g).  ``rows`` may be a shard
    rank's own rows: ``size`` then counts the leaf elements they hold."""
    for i, f in enumerate(np.asarray(m, np.float32)):
        if f != 1.0:
            rows[i].view(-1)[:size].mul_(float(f))


def _clip_rows(g: torch.Tensor, max_norm: float, mesh) -> None:
    """Clip each worker's rows of ``g`` ((w, R/S, C), a shard rank's own
    rows of an fsdp-averaged gradient; the pad is zero) in place by the
    worker's global norm: the rows' squared sums in fp32, one all-reduce
    over the shard group (counted "grad"), the root correctly rounded, as
    ``clip_by_global_norm`` scales."""
    sq = torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                      for x in g])
    mesh.all_reduce(sq, (coll.SHARD,), kind="grad")
    scale = torch.clamp(max_norm / torch.clamp(sqrt_rn(sq), min=1e-9),
                        max=1.0)
    for x, c in zip(g, scale):
        x.copy_((x.to(torch.float32) * c).to(x.dtype))


def make_train_step(model_cfg: ModelConfig, vrl_cfg: VRLConfig, *,
                    remat: bool = True, chunked_ce: int = 0,
                    device: torch.device | str = "cuda",
                    timed: bool = False, mesh=None,
                    param_dtype: torch.dtype = torch.float32) -> StepBundle:
    """``param_dtype`` (the reference's, fp32 by default) is the dtype of
    the parameters: ``init_state`` draws them in it, the engine's buffers
    (params, and the gradients the backward gives) hold it, and the model
    computes in it; Δ and the moments take ``vrl_cfg``'s ``delta_dtype``
    and ``moment_dtype``.  ``remat`` recomputes each layer's activations
    in the backward (``transformer.forward(remat=True)``; the reference's
    default, as here).  ``chunked_ce > 0`` streams the LM loss over vocab
    chunks of that size (``chunked_cross_entropy_lm`` on the
    post-final-norm hidden states, with ``embed`` as the head when it is
    tied): the (..., V) logits are never held.  Tokens are ids (W, B, S),
    or for the codec frontend frame embeddings (W, B, S, F).  ``timed``
    records CUDA-event spans around the forward/backward and the update of
    every step (``StepBundle.timer``); CUDA only.  ``mesh`` goes to
    ``core.engine.make_engine``."""
    device = torch.device(device)
    timer = PhaseTimer() if timed else None

    def span(name: str):
        return contextlib.nullcontext() if timer is None else timer.span(name)

    def loss_fn(params, tokens, labels, group=None):
        if chunked_ce:
            hidden, aux = transformer.forward(
                model_cfg, params, tokens, remat=remat, return_hidden=True,
                return_aux=True, group=group)
            tied = model_cfg.tie_embeddings
            loss = chunked_cross_entropy_lm(
                hidden, params["embed"] if tied else params["lm_head"],
                labels, chunk=chunked_ce, head_is_embed=tied)
        else:
            logits, aux = transformer.forward(model_cfg, params, tokens,
                                              remat=remat, return_aux=True,
                                              group=group)
            loss = cross_entropy_lm(logits, labels)
        if model_cfg.num_experts:
            # the router's load-balance loss, as the reference adds it
            loss = loss + model_cfg.router_aux_loss * aux
        return loss

    if engine_mod.resolve_backend(vrl_cfg, device) == "reference":
        if mesh is not None:
            raise ValueError(
                "update_backend='reference' (the per-leaf executor) is "
                "single-process: on a mesh every rank would run all W "
                "workers; use 'auto' or 'fused' with a mesh")
        return _reference_bundle(model_cfg, vrl_cfg, device, timer, span,
                                 loss_fn, param_dtype)
    template = abstract(transformer.model_defs(model_cfg), param_dtype)
    eng = engine_mod.make_engine(vrl_cfg, template, device=device, mesh=mesh)
    pods = eng.grid[0] if eng.grid is not None else 0
    spec = eng.spec
    gbuf: dict = {}             # params shape -> the reused gradient buffer
    fsdp = 1 if mesh is None else mesh.fsdp
    group = None if fsdp == 1 else coll.MeshGroup(mesh, (coll.FSDP,))

    def split(tokens) -> bool:
        """Whether the fsdp ranks split these (w, b, ...) batches: F > 1
        and F divides b (else each runs the whole batch)."""
        return fsdp > 1 and tokens.shape[1] % fsdp == 0

    def fsdp_slice(x: torch.Tensor) -> torch.Tensor:
        """This fsdp rank's contiguous slice of one worker's batch (b,
        ...)."""
        n = x.shape[0] // fsdp
        f = mesh.index((coll.FSDP,))[0]
        return x[f * n:(f + 1) * n]

    def dead_grads(state):
        """The last step's gradient buffer (dead once the step is done), as
        the fp32 scratch of a compressed sync's payload; None when the
        gradients are narrower (bf16 parameters): the sync then makes its
        own fp32 buffer, as the reference's does."""
        buf = gbuf.get(tuple(state.params.shape))
        return buf if buf is not None and buf.dtype == torch.float32 \
            else None

    def mean_loss(local: torch.Tensor, member: Any = (),
                  fsdp_split: bool = False) -> torch.Tensor:
        """(..., w) losses of this rank's workers -> (...) worker means (on
        a mesh over every rank's: one all-reduce of the local sums).  With
        a ``MemberState`` that leaves a worker out, the mean over the
        active workers (at least one), their count reduced in the same
        all-reduce and × its reciprocal, the reference's op sequence.
        ``fsdp_split``: the losses are of this rank's batch slices, first
        averaged over the fsdp ranks (one all-reduce)."""
        if fsdp_split:
            local = coll.worker_mean(mesh, local.unsqueeze(-1), -1,
                                     (coll.FSDP,), kind="scalar")
        if eng.all_active(member):
            return coll.worker_mean(mesh, local, -1, coll.AXES,
                                    kind="scalar")
        keep = member.active.reshape(-1) > 0
        s = torch.where(keep, local, 0).sum(dim=-1)
        cnt = keep.sum().to(s.dtype)
        if mesh is not None:
            both = torch.cat([s.reshape(-1), cnt.reshape(1)])
            mesh.all_reduce(both, kind="scalar")
            s, cnt = both[:-1].reshape(s.shape), both[-1]
        return s.mul_(torch.reciprocal(cnt.clamp(min=1.0)))

    def local_grads(state, tokens, labels):
        """Per-worker loss and gradients -> (gradient buffer of every row of
        this rank's workers: (W, R, C), or (P, D, R, C) for the hierarchy;
        the (w,) losses of this rank's workers).  On a row-sharded mesh the
        parameter rows are first gathered over the shard group (counted
        "forward") into a transient buffer: every shard rank runs its
        workers' whole forward and backward, so each clips the whole
        gradient.  On an fsdp axis that splits the batch (``split``) each
        worker runs this rank's slice, unclipped; the gradient is averaged
        over the fsdp group, then clipped (``fsdp_grads``), and on a
        row-sharded mesh what comes back is this rank's rows of it
        (shaped like ``state.params``)."""
        shape = (*state.params.shape[:-2], spec.rows, spec.lanes)
        buf = gbuf.get(shape)
        if buf is None:
            # pad tail stays zero: gradients only ever fill the leaf spans
            buf = gbuf[shape] = torch.zeros(shape, dtype=state.params.dtype,
                                            device=state.params.device)
        stacked = (-1, spec.rows, spec.lanes)    # the (W, R, C) views
        w = buf.view(stacked).shape[0]
        params = eng.gather_params(state)
        ptree = flat.unflatten_stacked(spec, params.view(stacked))
        gtree = flat.unflatten_stacked(spec, buf.view(stacked))
        if split(tokens):
            losses = [_worker_grads(
                lambda p, t, y: loss_fn(p, t, y, group), 0.0, ptree, gtree,
                (i,), fsdp_slice(tokens[i]), fsdp_slice(labels[i]))
                for i in range(w)]
            return fsdp_grads(state, buf, gtree, w), torch.stack(losses)
        losses = [_worker_grads(loss_fn, vrl_cfg.clip_norm, ptree, gtree,
                                (i,), tokens[i], labels[i])
                  for i in range(w)]
        return buf, torch.stack(losses)

    def fsdp_grads(state, buf: torch.Tensor, gtree, w: int) -> torch.Tensor:
        """The slices' gradients ``buf`` averaged over the fsdp group, then
        clipped to ``vrl_cfg.clip_norm`` by each worker's global norm: off
        a row-sharded mesh in place over every row (the whole tree's
        norm, ``clip_by_global_norm``); on one over this rank's rows only,
        copied out to a buffer shaped like ``state.params`` (returned), the
        norm's squared sums all-reduced over the shard group."""
        if eng.own_rows is None:
            coll.fsdp_mean(mesh, buf)
            if vrl_cfg.clip_norm:
                for i in range(w):
                    leaves = [x[i] for x in tree_mod.leaves(gtree)]
                    for x, c in zip(leaves, clip_by_global_norm(
                            leaves, vrl_cfg.clip_norm)):
                        x.copy_(c)
            return buf
        g = own_rows(state, buf)
        coll.fsdp_mean(mesh, g)
        if vrl_cfg.clip_norm:
            _clip_rows(g.view(-1, *g.shape[-2:]), vrl_cfg.clip_norm, mesh)
        return g

    def own_rows(state, g: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the full gradient buffer ``g`` (``g`` itself
        off a row-sharded mesh), kept as the step's dead buffer: a view
        into ``g`` where they are contiguous (one worker a rank), else
        copied into a reused buffer shaped like ``state.params``."""
        if eng.own_rows is None or g.shape[-2] != spec.rows:
            return g            # ... or already this rank's rows
        loc, shape = eng.own_rows(g), tuple(state.params.shape)
        if loc.is_contiguous():
            gbuf[shape] = loc
            return loc
        out = gbuf.get(shape)
        if out is None:
            out = gbuf[shape] = torch.empty_like(state.params)
        return out.copy_(loc)

    def grads_fn(state, tokens, labels):
        """``local_grads`` (this rank's rows, shaped like ``state.params``)
        with the losses' worker mean."""
        buf, losses = local_grads(state, tokens, labels)
        return own_rows(state, buf), mean_loss(losses, state.member,
                                               split(tokens))

    def step(state, tokens, labels, gmul: Optional[np.ndarray] = None):
        """One local step -> (state, this rank's (w,) worker losses);
        ``gmul``: this rank's workers' (w,) gradient multipliers."""
        with span("fwd_bwd"):
            g, losses = local_grads(state, tokens, labels)
            if gmul is not None:
                rows = g.shape[-2]
                # a shard rank's own rows hold the leaf elements past
                # its first row's offset
                start = (0 if rows == spec.rows else
                         mesh.index((coll.SHARD,))[0] * rows * spec.lanes)
                _grad_mul(g.view(-1, rows, spec.lanes),
                          max(0, min(spec.size - start, rows * spec.lanes)),
                          gmul)
            g = own_rows(state, g)
        with span("local"):
            state = eng.local_step(state, g)
        return state, losses

    def local_step(state, tokens, labels):
        state, losses = step(state, tokens, labels)
        return state, mean_loss(losses, state.member, split(tokens))

    # the last step's gradients are dead at a sync: a compressed sync
    # writes its decompressed payload over them instead of a new buffer
    def sync_step(state):
        with span("sync"):
            return eng.sync(state, out=dead_grads(state))

    def train_step(state, tokens, labels):
        state, loss = local_step(state, tokens, labels)
        if eng.sync_due(state):
            with span("sync"):
                state = eng.step_sync(state, out=dead_grads(state))
        return state, loss

    def round_step_fault(state, tokens_k, labels_k, gmul=None):
        """``round_step``; ``gmul``: None, or the (k, W) numpy multiplier
        of each step's and worker's gradient over the whole grid's workers
        (pod-major for the hierarchy; on a mesh this rank takes its
        workers' columns)."""
        overlap = eng.round_begin is not None
        if overlap:
            with span("round_begin"):
                xbar = eng.round_begin(state, len(tokens_k))
        if gmul is not None and mesh is not None:
            gmul = np.asarray(gmul)[:, local_workers(
                mesh, np.asarray(gmul).shape[1], pods)]
        losses = []
        for i, (tokens, labels) in enumerate(zip(tokens_k, labels_k)):
            state, loss = step(state, tokens, labels,
                               None if gmul is None else gmul[i])
            losses.append(loss)
        if overlap:
            with span("fold"):
                state = eng.round_fold(state, xbar, out=dead_grads(state))
        else:
            with span("sync"):
                state = eng.round_end(state, out=dead_grads(state))
        if mesh is None:
            return state, torch.stack([mean_loss(x, state.member)
                                       for x in losses])
        return state, mean_loss(torch.stack(losses), state.member,
                                split(tokens_k[0]))

    def round_step(state, tokens_k, labels_k):
        return round_step_fault(state, tokens_k, labels_k)

    def init_state(seed: int, num_workers: int):
        params = transformer.init_params(model_cfg, seed, param_dtype,
                                         device=device)
        return eng.init(params, num_workers)

    return StepBundle(init_state, train_step, local_step, sync_step,
                      grads_fn, eng.average_model, eng,
                      round_step=round_step, timer=timer,
                      sync1_step=eng.sync1, sync2_step=eng.sync2,
                      round_step_fault=round_step_fault,
                      health=lambda state, loss: _health(state, loss, mesh))


def _release(old: Any, new: Any) -> None:
    """Empty, in place, every tree (dict) of the state ``old`` that ``new``
    replaced, recursing into NamedTuple fields (CommState, AdamState, ...);
    trees ``new`` still holds are the same objects and are kept.  The
    per-leaf executor builds fresh dicts for what it replaces, so this
    drops exactly the replaced leaves, and a tensor that ``new`` still
    views stays alive through it."""
    if old is new:
        return
    if isinstance(old, dict):
        old.clear()
    elif isinstance(old, tuple) and hasattr(old, "_fields") and \
            type(old) is type(new):
        for a, b in zip(old, new):
            _release(a, b)


def _reference_bundle(model_cfg: ModelConfig, vrl_cfg: VRLConfig,
                      device: torch.device, timer, span: Callable,
                      loss_fn: Callable,
                      param_dtype: torch.dtype = torch.float32
                      ) -> StepBundle:
    """The train step over the per-leaf reference executor
    (``update_backend="reference"``; the reference's ``make_train_step``
    reference branch)."""
    if vrl_cfg.membership:
        raise ValueError(
            "membership (elastic fault tolerance) needs the flat-buffer "
            "engine's MemberState; update_backend='reference' has none — "
            "use 'auto', 'xla' or 'fused'")
    if vrl_cfg.overlap:
        raise ValueError(
            "overlap needs the flat-buffer engine (its double-buffered "
            "pend state); update_backend='reference' has no overlapped "
            "round — use 'auto', 'xla' or 'fused'")
    spec = engine_mod.get_spec(vrl_cfg.algorithm)
    engine_mod._validate_overlap(vrl_cfg, spec,
                                 comm_mod.resolve_pair(vrl_cfg)[0])
    alg = get_algorithm(vrl_cfg.algorithm)
    hier = spec.sync == "vrl2"
    hcfg = engine_mod.hier_config(vrl_cfg)

    def grads_fn(state, tokens, labels):
        """Per-worker loss and gradients -> (a gradient tree shaped like
        ``state.params``, mean loss over workers); tokens arrive
        worker-stacked (W, ...), worker i the grid's (i // D, i % D) under
        the hierarchy."""
        grads = tree_mod.tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.device),
            state.params)
        w = tokens.shape[0]
        losses = [_worker_grads(
            loss_fn, vrl_cfg.clip_norm, state.params, grads,
            divmod(i, hcfg.grid[1]) if hier else (i,), tokens[i], labels[i])
            for i in range(w)]
        return grads, torch.stack(losses).mean()

    def local_step(state, tokens, labels, gmul=None):
        """One local step; ``gmul``: None or the (W,) gradient multipliers
        (worker i the grid's (i // D, i % D) under the hierarchy)."""
        with span("fwd_bwd"):
            grads, loss = grads_fn(state, tokens, labels)
            for i, f in enumerate(np.asarray(() if gmul is None else gmul,
                                             np.float32)):
                if f != 1.0:
                    idx = divmod(i, hcfg.grid[1]) if hier else (i,)
                    for g in tree_mod.leaves(grads):
                        g[idx].mul_(float(f))
        with span("local"):
            state = alg.local_step(vrl_cfg, state, grads)
        del grads
        return state, loss

    def sync1(state):
        return engine_mod.ref_hier_sync1(vrl_cfg, state)

    def sync2(state):
        return engine_mod.ref_hier_sync2(vrl_cfg, state)

    def round_syncs(state) -> list:
        """The round-closing syncs; the hierarchy's round is one k1
        period: sync1, then sync2 when the k2 cadence is due."""
        if not hier:
            return [lambda s: alg.sync(vrl_cfg, s)]
        if hcfg.k2 % hcfg.k1:
            raise ValueError(f"round execution needs k2 % k1 == 0; got "
                             f"k1={hcfg.k1}, k2={hcfg.k2}")
        return [sync1] + ([sync2] if state.step - state.last_sync2
                          >= hcfg.k2 else [])

    def sync_step(state):
        with span("sync"):
            return alg.sync(vrl_cfg, state)

    def train_step(state, tokens, labels):
        """The algorithm's per-step ``train_step`` (its local step, then
        the syncs its cadence has due; their time falls in ``local``)."""
        with span("fwd_bwd"):
            grads, loss = grads_fn(state, tokens, labels)
        with span("local"):
            state = alg.train_step(vrl_cfg, state, grads)
        return state, loss

    def round_step_fault(state, tokens_k, labels_k, gmul=None):
        """k local steps, then the round-closing syncs; ``gmul``: None or
        the (k, W) gradient multipliers.  Consumes ``state``
        as the reference's round driver does (it donates the state to the
        compiled round): each tree a step replaces is emptied in place as
        soon as it is replaced, so the caller's handle on the round's start
        state pins no model-sized buffer while the round runs.  Use the
        state it returns."""
        losses = []
        for i, (tokens, labels) in enumerate(zip(tokens_k, labels_k)):
            prev, (state, loss) = state, local_step(
                state, tokens, labels, None if gmul is None else gmul[i])
            _release(prev, state)
            losses.append(loss)
        with span("sync"):
            for sync in round_syncs(state):
                prev, state = state, sync(state)
                _release(prev, state)
        return state, torch.stack(losses)

    def round_step(state, tokens_k, labels_k):
        return round_step_fault(state, tokens_k, labels_k)

    def init_state(seed: int, num_workers: int):
        params = transformer.init_params(model_cfg, seed, param_dtype,
                                         device=device)
        return alg.init(vrl_cfg, params, num_workers)

    return StepBundle(init_state, train_step, local_step, sync_step,
                      grads_fn, alg.average_model, None,
                      round_step=round_step, timer=timer,
                      sync1_step=sync1 if hier else None,
                      sync2_step=sync2 if hier else None,
                      round_step_fault=round_step_fault, health=_health)
