"""Device milliseconds an external step of the operations that the
program's packed and stage tables launched (the span
``ltjax_torch.tables``; ``ltbench.spans``)."""

from ltbench import spans


def read(obs):
    ms = spans.layer_device_ms(obs["trace"], ("tables",))
    return None if ms is None else ms / obs["ext_steps"]
