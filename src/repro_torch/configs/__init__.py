"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The same ids and aliases as ``repro.configs``.  One module per ported
architecture, each exporting FULL (the published config) and SMOKE (same
family, tiny dims, CPU-runnable); only zamba2-2.7b is ported so far, the
others raise ``KeyError`` until their families are (ROADMAP.md).
"""

import importlib

PORTED = ("zamba2_2p7b",)

# dashes/dots in CLI ids map to underscores in module names
_ALIASES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-2.7b": "zamba2_2p7b",
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-9b": "yi_9b",
    "grok-1-314b": "grok_1_314b",
    "mixtral-8x7b": "mixtral_8x7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-370m": "mamba2_370m",
}


def canonical(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def _module(arch_id: str):
    name = canonical(arch_id)
    if name not in PORTED:
        raise KeyError(f"architecture {arch_id!r} is not ported to repro_torch "
                       f"yet (ported: {', '.join(PORTED)}; see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).FULL


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE


def all_arch_ids():
    return list(_ALIASES.keys())
