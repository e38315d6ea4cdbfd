"""Model flops of the window's work (the driver's ``model_flops``, from the
configuration alone by counts/flops.py: training steps, clustering jobs or
scored documents) over the window's host-clock time and the card's
published bf16 peak, in %."""
from perfbench.counts import peaks


def read(run):
    w = run.window
    if not w.get("model_flops") or not w.get("seconds"):
        return None
    return 100.0 * w["model_flops"] / w["seconds"] / peaks.FLOPS["bf16"]
