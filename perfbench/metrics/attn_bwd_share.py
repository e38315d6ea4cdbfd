"""Device time of the kernels launched under the autograd node
``AttentionFunctionBackward`` (kernels/flash_attention/ops.py's backward)
over all device time of the traced steps, in %."""
from perfbench.readers import AUTOGRAD, share_under_host


def read(run):
    return share_under_host(run, AUTOGRAD + "AttentionFunctionBackward")
