"""The host's own milliseconds in a call of K1's wrapper: the span
``ltjax_torch.k1`` less its child ``ltjax_torch.k1.upload`` (the
host-to-device copies, which wait for the stream), the mean over the
calls of the traced window."""

from ltbench import spans


def read(obs):
    ms = spans.self_ms(obs["trace"], "k1")
    return sum(ms) / len(ms) if ms else None
