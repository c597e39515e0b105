from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    make_prefill,
    make_serve_step,
)
