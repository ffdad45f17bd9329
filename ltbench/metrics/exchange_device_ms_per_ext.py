"""Device milliseconds an external step of the NCCL kernels (the
migration's all_to_all of counts and rows, the chunk end's sum) on the
rank whose trace this is, the pace-setting one in the result.  A rank
that waits for another spins in these kernels: on the fast ranks their
time is mostly the wait (``rank_skew_pct``).  None on one card, or where
no NCCL kernel ran."""


def read(obs):
    if not obs.get("ranks"):
        return None
    us = [e - s for name, s, e in obs["trace"]["device"]
          if name.startswith("nccl")]
    return 1e-3 * sum(us) / obs["ext_steps"] if us else None
