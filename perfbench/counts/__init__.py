"""The yardstick's counts: model flops (``flops``), each kernel's operations
and bytes from its shapes (``kernels``) and the card's peaks (``peaks``)."""
