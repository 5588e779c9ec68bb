"""Assigned architecture configs (public-literature exact dims) + registry —
a copy of ``repro.configs`` (framework-free) with its imports rewritten.

Each module defines ``CONFIG`` (full-size) and the registry maps
``--arch <id>`` to it.  ``reduced()`` variants drive the CPU smoke tests.
"""

from repro_torch.configs import (dbrx_132b, deepseek_7b, gemma3_12b,
                                 internvl2_1b, llama3_8b, mamba2_130m,
                                 mixtral_8x7b, qwen3_14b, recurrentgemma_9b,
                                 seamless_m4t_large_v2)

ARCHS = {
    "qwen3-14b": qwen3_14b.CONFIG,
    "gemma3-12b": gemma3_12b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "internvl2-1b": internvl2_1b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
