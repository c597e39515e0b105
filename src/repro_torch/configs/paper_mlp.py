"""The paper's own transfer-learning model (§6.1), ``repro.configs
.paper_mlp``: an MLP on 2048-d Inception-V3 features, one hidden layer of
1024, 200 output classes, relu.  Used by the paper's convergence runs
(``repro_torch.paper``)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper-mlp"
    in_dim: int = 2048
    hidden: int = 1024
    classes: int = 200


CONFIG = MLPConfig()
