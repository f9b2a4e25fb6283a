"""peak_alloc_gib: `torch.cuda.max_memory_allocated` over the traced window
(peaks reset at its start), on the fullest card, in GiB. Layer: device."""


def read(view):
    if view.peak_alloc_bytes is None:
        return None
    return view.peak_alloc_bytes / 2**30
