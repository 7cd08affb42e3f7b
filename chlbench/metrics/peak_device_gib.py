"""``peak_device_gib``: the card's peak allocated memory over set-up and
window (``torch.cuda.max_memory_allocated``), in GiB; nothing off the
card."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
