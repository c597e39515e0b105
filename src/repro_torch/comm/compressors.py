"""Sync-payload compression (``repro.comm.compressors``).

Every sync transmits the DRIFT of each worker's payload against a shared
reference ``ref`` — the value every worker holds after the last sync — so
the mean reconstructs exactly, ``mean_i(x_i) = ref + mean_i(x_i − ref)``.
The drift goes through a lossy round trip, and with error feedback the
error ``payload − decompress(compress(payload))`` is carried per worker in
a residual and added to the next payload (EF-SGD).  S-SGD compresses its
per-step gradient all-reduce instead, with ref ≡ 0.

Compressors over the engine's (R, C) payload rows (``core/flat``):

  * ``none`` — identity; the engine takes its uncompressed path, bitwise,
    with no extra state.
  * ``int8`` — per-row-scaled linear quantisation: scale = max|row|/127,
    q = round(x/scale) clipped to ±127.  Wire: 1 byte per element plus one
    fp32 scale per row.
  * ``topk[:rate]`` — per-row magnitude sparsification keeping k = C //
    rate lanes (fixed k: values plus int32 indices).  ``rate=1`` keeps
    every lane and resolves to the identity path.

``ef_int8`` / ``ef_topk`` are the canonical round-trip math, fp32 in and
out; the residual is the literal subtraction, so ``resid + dec ==
payload`` bitwise.  They are the plain versions the engine's CUDA kernels
(``kernels/vrl_update.fused_ef_*``) are held against, and ``ef_leaf``
runs them leaf by leaf for the per-leaf reference executor.  ``compress`` /
``decompress`` build the actual wire arrays, so byte counts are measured
(``rep_nbytes``), not assumed; ``wire_bytes`` is the same count from the
shapes alone.  The wire skips the layout's tile-padding rows (``used_rows``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

COMPRESSORS = ("none", "int8", "topk")
_DEFAULT_TOPK_RATE = 32


class CompressorSpec(NamedTuple):
    """A named wire format for the sync payload.

    ``rate`` is the top-k keep divisor (k = lanes // rate survivors per
    row); 0 for compressors without a rate, so specs compare canonically.
    ``error_feedback`` carries the compression error across rounds in a
    per-worker residual.
    """

    name: str
    rate: int = 0
    error_feedback: bool = True

    def label(self) -> str:
        tag = f":{self.rate}" if self.name == "topk" else ""
        ef = "" if self.error_feedback or self.name == "none" else ":noef"
        return f"{self.name}{tag}{ef}"


def parse_compressor(text: str) -> CompressorSpec:
    """CLI syntax for ``--compress``: ``none``, ``int8``, ``topk`` (rate
    32), ``topk:8`` (explicit keep divisor), any of them with ``:noef``
    (error feedback off) or ``:ef``."""
    parts = [p for p in text.split(":") if p]
    if not parts or parts[0] not in COMPRESSORS:
        raise ValueError(f"unknown compressor {text!r}; expected "
                         f"{'|'.join(COMPRESSORS)}[:rate][:noef]")
    name = parts[0]
    rate = _DEFAULT_TOPK_RATE if name == "topk" else 0
    ef = True
    for p in parts[1:]:
        if p == "noef":
            ef = False
        elif p == "ef":
            ef = True
        elif p.isdigit():
            if name != "topk":
                raise ValueError(f"{name!r} takes no rate (got {text!r})")
            rate = int(p)
        else:
            raise ValueError(f"bad compressor option {p!r} in {text!r}")
    return CompressorSpec(name=name, rate=rate, error_feedback=ef)


def as_spec(c) -> Optional[CompressorSpec]:
    if c is None or isinstance(c, CompressorSpec):
        return c
    if isinstance(c, str):
        return parse_compressor(c)
    raise TypeError(f"expected CompressorSpec | str | None, got {type(c)}")


def is_identity(c) -> bool:
    """True when the compressor changes nothing: the engine then takes its
    uncompressed path (bitwise, no extra state buffers)."""
    c = as_spec(c)
    if c is None or c.name == "none":
        return True
    return c.name == "topk" and c.rate <= 1


def resolve(c) -> Optional[CompressorSpec]:
    """Spec for an active compressor, None for the identity path."""
    c = as_spec(c)
    return None if is_identity(c) else c


def resolve_pair(cfg) -> Tuple[Optional[CompressorSpec],
                               Optional[CompressorSpec]]:
    """(level-1, level-2) compressors of a VRLConfig.  ``compress`` drives
    the flat algorithms' sync; ``compress2`` overrides the hierarchy's
    cross-pod sync and falls back to ``compress`` when unset (the flat
    algorithms ignore level 2, as in the reference)."""
    c1 = resolve(getattr(cfg, "compress", None))
    c2_raw = getattr(cfg, "compress2", None)
    c2 = resolve(c2_raw) if c2_raw is not None else c1
    return c1, c2


def topk_k(spec: CompressorSpec, lanes: int) -> int:
    """Survivors per row, fixed by the spec and the lane count."""
    return max(1, lanes // max(spec.rate, 1))


def used_rows(size: int, lanes: int) -> int:
    """Rows carrying real elements: the wire skips pure tile padding."""
    return -(-size // lanes)


# ============================================================== EF round trip
# Over (..., R, C) fp32 payloads; returns (decompressed, residual).  Written
# op for op as the reference's jnp, so it is bitwise the JAX package's
# eager result on the CPU.  The divisor 127 is a tensor on the payload's
# device: PyTorch's CUDA division by a Python scalar multiplies by its
# reciprocal instead, which rounds differently from the IEEE division the
# reference and the CUDA kernel perform.

def ef_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row-scaled int8 round trip: scale = max|row|/127, symmetric
    round half to even, clip ±127, dec = q·scale.  All-zero rows quantise
    to zero exactly."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = amax / amax.new_full((), 127.0)
    safe = torch.where(amax > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0)
    dec = q * scale
    return dec, x - dec


def ef_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude lanes per row, zero the rest.

    Selection is by threshold (the kth magnitude of the row), so every lane
    tied with the threshold is kept (≥ k survivors), as in the reference;
    the fixed-k wire format (``compress``) carries exactly k of them."""
    c = x.shape[-1]
    if k >= c:
        return x, torch.zeros_like(x)
    a = torch.abs(x)
    thresh = torch.topk(a, k, dim=-1).values[..., k - 1:k]
    dec = torch.where(a >= thresh, x, torch.zeros_like(x))
    return dec, x - dec


def ef_roundtrip(spec: CompressorSpec, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ef_int8`` / ``ef_topk`` by spec over an (..., R, C) payload."""
    if spec.name == "int8":
        return ef_int8(x)
    if spec.name == "topk":
        return ef_topk(x, topk_k(spec, x.shape[-1]))
    return x, torch.zeros_like(x)          # "none": identity


def ef_leaf(spec: CompressorSpec, payload: torch.Tensor, n_lead: int,
            lanes: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf EF round trip for the per-leaf reference executor.

    ``payload``: fp32 with ``n_lead`` leading worker axes; the trailing
    leaf dims are raveled into rows of ``lanes`` (zero-padded tail), so
    rows are aligned to the leaf, where the flat engine's are aligned to
    its layout: a compressed per-leaf run and a flat one agree only
    approximately, as in the reference.  Returns (dec, resid) shaped like
    ``payload``."""
    lead = tuple(payload.shape[:n_lead])
    n = math.prod(payload.shape[n_lead:])
    u = used_rows(n, lanes)
    flat = payload.reshape(lead + (n,))
    pad = u * lanes - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    dec2, res2 = ef_roundtrip(spec, flat.reshape(lead + (u, lanes)))

    def back(b: torch.Tensor) -> torch.Tensor:
        return b.reshape(lead + (u * lanes,))[..., :n].reshape(payload.shape)

    return back(dec2), back(res2)


# ================================================================ wire format
class Int8Rep(NamedTuple):
    values: torch.Tensor         # (..., U, C) int8
    scales: torch.Tensor         # (..., U, 1) fp32


class TopKRep(NamedTuple):
    values: torch.Tensor         # (..., U, K) fp32
    indices: torch.Tensor        # (..., U, K) int32 lane offsets


class RawRep(NamedTuple):
    values: torch.Tensor         # (..., U, C) payload dtype


def compress(spec: CompressorSpec, x: torch.Tensor, *,
             rows_used: Optional[int] = None):
    """Payload (..., R, C) → the wire representation arrays.  ``rows_used``
    drops the trailing tile-padding rows (zero by the layout's
    construction).  Measures bytes; the engine never calls it."""
    if rows_used is not None:
        x = x[..., :rows_used, :]
    x = x.to(torch.float32)
    if spec.name == "int8":
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        scale = amax / amax.new_full((), 127.0)
        safe = torch.where(amax > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(x / safe), -127.0, 127.0)
        return Int8Rep(values=q.to(torch.int8), scales=scale)
    if spec.name == "topk":
        k = topk_k(spec, x.shape[-1])
        idx = torch.topk(torch.abs(x), k, dim=-1).indices
        vals = torch.gather(x, -1, idx)
        return TopKRep(values=vals, indices=idx.to(torch.int32))
    return RawRep(values=x)


def decompress(spec: CompressorSpec, rep, *, rows: int,
               lanes: int) -> torch.Tensor:
    """Wire representation → the dense (..., R, C) fp32 payload, dropped
    padding rows restored as zeros."""
    if spec.name == "int8":
        dec = rep.values.to(torch.float32) * rep.scales
    elif spec.name == "topk":
        v, idx = rep.values, rep.indices
        dec = torch.zeros(v.shape[:-1] + (lanes,), dtype=torch.float32,
                          device=v.device)
        dec.scatter_(-1, idx.to(torch.int64), v)
    else:
        dec = rep.values.to(torch.float32)
    u = dec.shape[-2]
    if rows > u:
        pad = dec.new_zeros(dec.shape[:-2] + (rows - u, dec.shape[-1]))
        dec = torch.cat([dec, pad], dim=-2)
    return dec


def rep_nbytes(rep) -> int:
    """Measured wire bytes of a compressed representation."""
    return int(sum(a.numel() * a.element_size() for a in rep))


def raw_bytes(rows: int, lanes: int, itemsize: int = 4) -> int:
    """The uncompressed baseline: the whole padded flat buffer that the
    sync's worker mean carries."""
    return rows * lanes * itemsize


def wire_bytes(spec: Optional[CompressorSpec], *, rows: int, lanes: int,
               size: Optional[int] = None, itemsize: int = 4) -> int:
    """One-way wire bytes for one (R, C) payload under ``spec``; ``size``
    (the real element count) elides the padding rows.  Equals
    ``rep_nbytes(compress(...))``."""
    if spec is None or is_identity(spec):
        return raw_bytes(rows, lanes, itemsize)
    u = used_rows(size, lanes) if size is not None else rows
    if spec.name == "int8":
        return u * lanes * 1 + u * 4
    if spec.name == "topk":
        return u * topk_k(spec, lanes) * (4 + 4)
    raise ValueError(spec.name)


# =================================================================== metadata
def meta(c) -> Optional[dict]:
    """JSON-safe description of one compressor."""
    c = resolve(c)
    if c is None:
        return None
    return {"name": c.name, "rate": int(c.rate),
            "error_feedback": bool(c.error_feedback)}


def pair_meta(cfg_or_pair) -> Optional[dict]:
    """Per-level compressor metadata of a VRLConfig (or an explicit
    (level1, level2) pair); None when fully uncompressed."""
    if isinstance(cfg_or_pair, tuple):
        c1, c2 = cfg_or_pair
    else:
        c1, c2 = resolve_pair(cfg_or_pair)
    if c1 is None and c2 is None:
        return None
    return {"level1": meta(c1), "level2": meta(c2)}


def describe_pair(cfg_or_pair) -> str:
    """Human-readable per-level summary for the launch banner."""
    if isinstance(cfg_or_pair, tuple):
        c1, c2 = cfg_or_pair
    else:
        c1, c2 = resolve_pair(cfg_or_pair)
    if c1 is None and c2 is None:
        return "none"
    l1 = c1.label() if c1 else "none"
    if c2 == c1 or c2 is None:
        return l1
    return f"{l1} / sync2={c2.label()}"
