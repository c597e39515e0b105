"""Sync-payload compression (``repro.comm``): int8 quantisation and top-k
sparsification with error feedback, applied to the engine's per-round
payload and measured in bytes."""
from repro_torch.comm.compressors import (  # noqa: F401
    COMPRESSORS,
    CompressorSpec,
    compress,
    decompress,
    describe_pair,
    ef_int8,
    ef_leaf,
    ef_roundtrip,
    ef_topk,
    is_identity,
    meta,
    pair_meta,
    parse_compressor,
    raw_bytes,
    rep_nbytes,
    resolve,
    resolve_pair,
    topk_k,
    used_rows,
    wire_bytes,
)
