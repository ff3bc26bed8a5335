"""The fields of a port configuration that the reference's schema has:
the parity tests compare those with the reference's, after checking that
the port's own further fields hold the defaults that keep the reference's
behaviour."""
import dataclasses

# DeepSeek-V2's YaRN and leading dense layers
PORT_DEFAULTS = {"rope_scaling": None, "first_k_dense_replace": 0}
# DeepSeek-V2's held and shared experts, unrenormalised weights and the
# sequence loss
PORT_MOE_DEFAULTS = {"n_router": None, "first_expert": 0, "n_shared": 0,
                     "norm_topk": True, "balance": "switch"}


def reference_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own further fields,
    each asserted to hold its default."""
    fields = dataclasses.asdict(cfg)
    for part, defaults in ((fields, PORT_DEFAULTS),
                           (fields["moe"] or {}, PORT_MOE_DEFAULTS)):
        for key, default in defaults.items():
            assert part.pop(key, default) == default, key
    return fields
