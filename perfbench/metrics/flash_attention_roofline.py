"""The least time of the traced window's flash_attention calls
(counts/kernels.py at the cell's shapes: GQA, window, causal; bf16 peak)
over the device time of the attention kernels (readers.KERNELS), in %."""
from perfbench.counts import kernels
from perfbench.readers import roofline


def read(run):
    m, tr = run.cell.config["model"], run.cell.traffic
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    flop, nbytes = kernels.attention(tr["batch"], m["n_heads"], m["n_kv_heads"],
                                     tr["seq"], hd, m.get("attn_window", 0))
    return roofline(run, "flash_attention", flop, nbytes, "bf16")
