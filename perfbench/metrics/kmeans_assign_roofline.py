"""The least time of the traced job's kmeans_assign calls (counts/kernels.py
at the job's n x d and k, float32 operands against the TF32 peak) over the
device time of the assignment kernels (readers.KERNELS), in %."""
from perfbench.counts import kernels
from perfbench.readers import roofline


def read(run):
    tr, m = run.cell.traffic, run.cell.config["model"]
    n = tr["batches"] * tr["batch"] * tr["seq"]
    flop, nbytes = kernels.kmeans_assign(n, m["d_model"], tr["clusters"])
    return roofline(run, "kmeans_assign", flop, nbytes, "tf32")
