"""Device milliseconds an external step of the operations that the
program's Hilbert sort and unsort launched (the spans
``ltjax_torch.sort`` and ``ltjax_torch.unsort``; ``ltbench.spans``)."""

from ltbench import spans


def read(obs):
    ms = spans.layer_device_ms(obs["trace"], ("sort", "unsort"))
    return None if ms is None else ms / obs["ext_steps"]
