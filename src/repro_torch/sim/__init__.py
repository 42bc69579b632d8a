"""The synchronous HFL environment and its hardware simulator."""
from repro_torch.sim.env import EnvConfig, HFLEnv  # noqa: F401
from repro_torch.sim.hardware import CommModel, DeviceProfiles  # noqa: F401
