"""Fault tolerance for the streaming executor's lanes: straggler and
speculation policy, the lane liveness state machine and fault injection
(the port of ``repro.ft``; pure Python and numpy)."""
from repro_torch.ft.stragglers import (SpeculativeConfig, SpeculativePolicy,
                                       StragglerConfig, StragglerMonitor,
                                       WallTracker)
from repro_torch.ft.coordinator import Coordinator, CoordinatorConfig, State
from repro_torch.ft.chaos import (CancelledFetch, FaultySplitSource,
                                  LaneChaos, LaneDeath, TransientSplitError)
