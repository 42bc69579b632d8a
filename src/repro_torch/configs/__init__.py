"""Config registry. One module per assigned architecture (+ the paper's own
MNIST/CIFAR CNNs used by the faithful reproduction)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    MoEConfig,
    all_arch_names,
    get_config,
    register,
)

_LOADED = False


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        deepseek_7b,
        grok_1_314b,
        olmoe_1b_7b,
        phi3_medium_14b,
        qwen2_72b,
        qwen2_vl_7b,
        qwen3_1_7b,
        rwkv6_1_6b,
        whisper_base,
        zamba2_7b,
    )
