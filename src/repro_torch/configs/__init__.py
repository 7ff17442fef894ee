"""Architecture registry of the port (dense and MoE families).  Each module exposes
``config()`` (the published configuration) and ``smoke_config()`` (a
reduced same-family configuration for CPU tests), as in
``repro/configs``."""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma2_2b", "mixfp4_476m", "qwen2_moe_a2_7b",
            "qwen3_moe_30b_a3b", "phi3_medium_14b", "starcoder2_15b",
            "h2o_danube_3_4b", "mixfp4_114m"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_arch(name: str):
    """The config module for an arch id (dash or underscore form)."""
    mod = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise ValueError(f"arch {name!r} is not ported (ported: "
                         f"{sorted(_ALIAS)}); other families are ROADMAP "
                         "§1 item 5")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def config(name: str):
    return get_arch(name).config()


def smoke_config(name: str):
    return get_arch(name).smoke_config()
