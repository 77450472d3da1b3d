"""Distributed runtime concerns (host Python, copied from
`repro.distributed`): fault tolerance and stragglers."""
from repro_torch.distributed.fault import (FailureInjector, HeartbeatMonitor,
                                           run_with_recovery)
from repro_torch.distributed.stragglers import StragglerDetector

__all__ = ["FailureInjector", "HeartbeatMonitor", "run_with_recovery",
           "StragglerDetector"]
