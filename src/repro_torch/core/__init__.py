"""The ds-array core of the port: geometry, the DsArray type, creation
routines and the block-native structural ops."""

from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dsarray import (PAD_DIRTY, PAD_ZERO, DsArray, PadState,
                                      eye, from_array, full, matmul_ta,
                                      pad_state_of, random_array, zeros)
from repro_torch.core.structural import gram

__all__ = ["BlockGrid", "DsArray", "PadState", "PAD_ZERO", "PAD_DIRTY",
           "pad_state_of", "from_array", "zeros", "full", "eye",
           "random_array", "matmul_ta", "gram"]
