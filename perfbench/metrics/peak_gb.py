"""``torch.cuda.max_memory_allocated`` over the measured window (reset at
its start), in GB of 1e9 bytes."""


def read(run):
    peak = run.window.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
