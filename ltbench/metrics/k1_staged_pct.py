"""K1's block-steps served by its staged corner source [%]: the device
counters ``staged_block_steps / (staged + global)`` of the traced
window."""


def read(obs):
    c = obs.get("staging")
    if not c:
        return None
    tot = c["staged_block_steps"] + c["global_block_steps"]
    return 100.0 * c["staged_block_steps"] / tot if tot else None
