from repro_torch.optim.optimizers import (AdamState, Optimizer, adam,
                                         adam_scal, inner_kind, make_inner,
                                         momentum, sgd)

__all__ = ["AdamState", "Optimizer", "adam", "adam_scal", "inner_kind",
           "make_inner", "momentum", "sgd"]
