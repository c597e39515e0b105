from repro_torch.data.partition import contiguous_assignment  # noqa: F401
from repro_torch.data.synthetic import assigned_token_stream  # noqa: F401
