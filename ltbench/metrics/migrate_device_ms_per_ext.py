"""Device milliseconds an external step of the operations that the
program's migration launched (the span ``ltjax_torch.migrate`` and its
child ``ltjax_torch.exchange``; ``ltbench.spans``), NCCL's kernels left
out: ``exchange_device_ms_per_ext`` reads those.  None where the window
holds no such span: on one card, or a program without it."""

from ltbench import spans, trace

LAYERS = ("migrate", "exchange")


def read(obs):
    t = obs["trace"]
    names = tuple(spans.PREFIX + x for x in LAYERS)
    if not any(h[0] in names for h in t["host"]):
        return None
    recs = [r for name, rs in spans.device_by_span(t).items()
            if name in names or name.startswith(tuple(n + "." for n in names))
            for r in rs if not r[0].startswith(spans.NCCL)]
    return 1e-3 * trace.busy_us(recs, t["span"]) / obs["ext_steps"]
