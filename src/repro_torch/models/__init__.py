"""Models."""
from . import moe, multimodal, ssm
from .model import (abstract_params, decode_step, forward, init_caches,
                    init_params, loss_fn, prefill)

__all__ = ["abstract_params", "decode_step", "forward", "init_caches",
           "init_params", "loss_fn", "moe", "multimodal", "prefill", "ssm"]
