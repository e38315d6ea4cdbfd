"""The least time of the traced window's ssd_chunk calls (counts/kernels.py
at the cell's shapes, float32 operands against the TF32 peak) over the
device time of the SSD kernels (readers.KERNELS), in %."""
from perfbench.counts import kernels
from perfbench.readers import roofline


def read(run):
    m, tr = run.cell.config["model"], run.cell.traffic
    if not m.get("ssm_state"):
        return None
    b = tr["batch"]
    heads = m.get("ssm_expand", 2) * m["d_model"] // m.get("ssm_headdim", 64)
    flop, nbytes = kernels.ssd_chunk(b * heads, tr["seq"], m.get("ssm_headdim", 64),
                                     m["ssm_state"], b * m.get("ssm_ngroups", 1),
                                     m.get("ssm_chunk", 128))
    return roofline(run, "ssd_chunk", flop, nbytes, "tf32")
