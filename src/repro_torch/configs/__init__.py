"""Architecture registry (PyTorch port of ``repro.configs``): the 10
assigned architectures and the 4 assigned input shapes.  Shape-only data;
the port's model runs the dense GQA family of them."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from .chatglm3_6b import CONFIG as chatglm3_6b
from .command_r_35b import CONFIG as command_r_35b
from .dbrx_132b import CONFIG as dbrx_132b
from .gemma3_12b import CONFIG as gemma3_12b
from .mamba2_780m import CONFIG as mamba2_780m
from .minicpm3_4b import CONFIG as minicpm3_4b
from .musicgen_large import CONFIG as musicgen_large
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .shapes import SHAPES, InputShape, concrete_inputs, input_specs
from .zamba2_2p7b import CONFIG as zamba2_2p7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        chatglm3_6b, gemma3_12b, zamba2_2p7b, qwen2_vl_7b, dbrx_132b,
        musicgen_large, mamba2_780m, command_r_35b, minicpm3_4b,
        qwen3_moe_235b_a22b,
    ]
}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise ValueError(f"unknown shape {name!r}; have {sorted(SHAPES)}")


__all__ = [
    "ARCHS", "SHAPES", "InputShape", "ModelConfig", "concrete_inputs",
    "get_arch", "get_shape", "input_specs",
]
