from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerMonitor, restartable_train)

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerMonitor",
           "restartable_train"]
