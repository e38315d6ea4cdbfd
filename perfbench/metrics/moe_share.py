"""Device time of the kernels launched under the range the harness places
around ``models.moe.moe_apply`` (``perfbench.moe_apply``) over all device
time of the traced documents, in %."""
from perfbench.readers import share_under_host


def read(run):
    return share_under_host(run, "perfbench.moe_apply")
