"""flowgen_torch: the PyTorch / CUDA port of flowgen for NVIDIA Hopper.

On-the-fly optical-flow training data: two 512x384 frames of a textured
background and 16-24 textured moving shapes per sample, and the dense
forward flow between them, generated from ``(seed, step)``. The JAX package
``flowgen`` stays the reference; this package imports neither it nor JAX.

Ported so far: the mode-7 main path (and the other rigid modes): threefry
scene sampling, the scene-kernel precompute, the hand-written CUDA scene
kernel (``csrc/scene.cu``) with its plain PyTorch version, the output
adapter and the streaming ``Generator``; mode 9: the warp-field bank
(``warpfields/``, CUDA kernels in ``csrc/fields.cu``) and the scene
kernel's displacement warps (``csrc/warp.cuh``); and modes 11 and 13
(quadrant slabs, 2x2 frame-1 texture sub-windows), the inverse flow
(``flow1``) and the occlusion and motion-boundary masks; and the windowed
renderer (``compose/render.py``, CUDA kernels in ``csrc/window.cu``) for
frames that are not multiples of (8, 128), such as MPI-Sintel's 1024x436;
and texture databases (``TextureDB``, the native loader, each source's own
field of view) and photometric augmentation (CUDA kernel in
``csrc/photometric.cu``).
"""

from .config import (
    DEFAULT_HEIGHT,
    DEFAULT_WIDTH,
    MODES,
    DataGenConfig,
    ModeSpec,
    disparity_mode,
    register_mode,
)
from .texture_io import (
    TextureDB,
    atlas_for_config,
    build_texture_db,
    load_texture_db,
    procedural_atlas,
)

__all__ = [
    "DEFAULT_HEIGHT",
    "DEFAULT_WIDTH",
    "MODES",
    "DataGenConfig",
    "ModeSpec",
    "disparity_mode",
    "register_mode",
    "TextureDB",
    "atlas_for_config",
    "build_texture_db",
    "load_texture_db",
    "procedural_atlas",
]
