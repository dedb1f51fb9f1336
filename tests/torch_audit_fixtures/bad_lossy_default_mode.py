"""PLANTED VIOLATIONS — lossy_default_mode.

Compression-mode parameters whose DEFAULT is a lossy wire dtype: every
caller that passes nothing is silently re-routed onto a lossy wire.
"""


def quantized_reduce(tree, group, mode="int8"):  # bad: default is lossy
    return tree, group, mode


def stat_sync(s, sq, count, *, stats_compress="bf16"):  # bad: kw-only lossy
    return s, sq, count, stats_compress


class Trainer:
    def __init__(self, model, compress="int8"):  # bad: trainer-level lossy
        self.model = model
        self.compress = compress

    def reduce(self, grads, grad_compression="bf16"):  # bad: the legacy knob too
        return grads, grad_compression


def clean_reduce(tree, group, mode="none"):  # ok: exact default
    return tree, group, mode


def explicit_call_site(tree):
    # passing a lossy literal at a CALL site is the opt-in, not a hit
    return quantized_reduce(tree, None, mode="int8")
