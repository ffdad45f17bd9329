"""How far the busiest rank's K1 device time in the traced episode lies
over the ranks' mean [%]: 100 (max / mean - 1) over ``obs["ranks"]``
(each rank's K1 ms: its launches times its mean profiled launch,
``layers.roofline``).  The strips' particle loads set it; the all_to_all
makes every rank wait for the busiest.  None on one card."""


def read(obs):
    ranks = obs.get("ranks")
    ms = [r["k1_ms"] for r in ranks or []]
    if not ms or any(m is None for m in ms):
        return None
    mean = sum(ms) / len(ms)
    return 100.0 * (max(ms) / mean - 1.0) if mean > 0 else None
