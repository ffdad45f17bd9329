"""K1's block-steps served by its staged corner source one tile at a time
(a split box, of up to three times the points of three tiles) [%]: the
device counters ``split_block_steps / (staged + global)`` of the traced
window.  A program without the counter gives None."""


def read(obs):
    c = obs.get("staging")
    if not c or "split_block_steps" not in c:
        return None
    tot = c["staged_block_steps"] + c["global_block_steps"]
    return 100.0 * c["split_block_steps"] / tot if tot else None
