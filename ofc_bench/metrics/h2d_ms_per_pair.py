"""h2d_ms_per_pair: device time of host-to-device copies in the traced
window per flow pair, in ms. Layer: pipeline loop copies (`process_frames`,
`_stream_tables` of `pipeline/bounce.py`)."""


def read(view):
    copies = [e for e in view.device_events if e.cat == "gpu_memcpy" and "HtoD" in e.name]
    if not copies or not view.pairs:
        return None
    return sum(e.dur for e in copies) / 1e3 / view.pairs
