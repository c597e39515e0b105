from repro_torch.optim.optimizers import (AdamState, Optimizer, SM3Pair,
                                         adam, adam_scal, inner_kind,
                                         make_inner, momentum, sgd)

__all__ = ["AdamState", "Optimizer", "SM3Pair", "adam", "adam_scal",
           "inner_kind", "make_inner", "momentum", "sgd"]
