"""Static configuration constants of the tri and tet renderers.

The same values as the JAX package's ``utils/config.py`` (kept as a copy:
the port imports nothing of that package).

``BIN_TILE`` is semantic, not only a launch shape: a face is tested only
against pixels of the tiles in its bounding rect, and for faces with a
vertex near the w=0 plane the wrapped int32 edge functions can pass outside
that rect, so the rect granularity decides their coverage. Every tri path
(dense oracle, binned CUDA kernel, plain composite) therefore shares one
32-px rect granularity, even though the CUDA kernel runs 16x16-pixel blocks.
"""

# Transmittance early-exit threshold.
T_EPS = 1e-4

# Binning tile side and coverage-rect granularity of every tri path.
BIN_TILE = 32

# Tile side of the dense tet first hit's preprocess (culling and depth keys
# only, which do not depend on it; the binned first hit uses BIN_TILE).
TILE_X = 16
TILE_Y = 16

# Fixed-point subpixel resolution of the coverage test. Part of the coverage
# contract: the pixel sample of pixel (x, y) is (16x + 8, 16y + 8).
SUBPIXEL = 16.0

# Number of colour channels.
NUM_CHANNELS = 3

# clamp_w epsilon guarding the perspective divide.
W_EPS = 1e-4

# Cap on the tet ray march's steps per ray.
DEFAULT_MAX_MARCH_STEPS = 512
