"""Row-banded rendering over a grid of devices (the port of
diligentfx_tpu/parallel): `mesh` builds the grid and exchanges band halos,
`tiling` renders forward and deferred frames band by band."""
from diligentfx_tpu_torch.parallel import mesh as mesh
