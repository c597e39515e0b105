# Deterministic fault injection for elastic fault-tolerant rounds
# (``repro.fault``): seedable schedules of gradient poison (NaN/Inf/scale),
# worker crash/rejoin, and simulated mid-save kills, consumed by
# launch/train.py's chaos path.
from repro_torch.fault.schedule import (  # noqa: F401
    FaultEvent,
    FaultSchedule,
    GRAD_KINDS,
    KINDS,
    MEMBER_KINDS,
)
