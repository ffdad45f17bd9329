"""Device-idle milliseconds of the traced window that fall inside the
program's spans (``ltjax_torch.*``), per chunk (``ltjax_torch.chunk``
spans).  The rest of the window's idle time lies between the program's
calls, in the caller."""

from ltbench import spans


def read(obs):
    t = obs["trace"]
    chunks = sum(h[0] == spans.PREFIX + "chunk" for h in t["host"])
    us = spans.program_idle_us(t)
    return None if us is None or not chunks else 1e-3 * us / chunks
