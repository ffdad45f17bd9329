"""Particles sent through the migration's all_to_all an external step, as
a share of ``numpar`` [%]: the program's ``sent`` counts of
``shard.make_tiled_steps``, summed over the ranks (``obs["ranks"]``) in
the traced episode.  None on one card."""


def read(obs):
    ranks = obs.get("ranks")
    if not ranks:
        return None
    sent = sum(r["migrated"] for r in ranks)
    return 100.0 * sent / (obs["numpar"] * obs["ext_steps"])
