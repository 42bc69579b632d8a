"""The HFL environments (synchronous and event-driven asynchronous) and
their hardware simulator."""
from repro_torch.sim.env import AsyncHFLEnv, EnvConfig, HFLEnv  # noqa: F401
from repro_torch.sim.hardware import CommModel, DeviceProfiles  # noqa: F401
