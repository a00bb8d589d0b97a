"""flowgen_torch: the PyTorch / CUDA port of flowgen for NVIDIA Hopper.

On-the-fly optical-flow training data: two 512x384 frames of a textured
background and 16-24 textured moving shapes per sample, and the dense
forward flow between them, generated from ``(seed, step)``. The JAX package
``flowgen`` stays the reference; this package imports neither it nor JAX.

Quick start::

    import flowgen_torch

    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=8, seed=0)
    gen = flowgen_torch.Generator(cfg)     # on the card; device="cpu" to ask
    batch = gen.retrieve_batch()           # {'image0','image1','flow0'}

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
``csrc/photometric.cu``); mode 9's second content stream
(``warp_bank_impl="xla"``); the Caffe prototxt front end
(``pipeline/prototxt.py``), the data-loader adapters
(``pipeline/adapters.py``), flow file IO and metrics (``utils/``), and the
FlowNetS trainer (``train/``); and generation over several devices
through a ``torch.distributed`` ``DeviceMesh`` (``pipeline/sharding.py``,
the ``mesh`` argument of ``Generator`` and ``make_generate_fn``), FlowNetS
with its output channels split over a ``model`` mesh dimension
(``train/flownet.py:shard_model``), the profiling utilities
(``utils/profiling.py``) and a copy of the scalar numpy oracle
(``reference_check/oracle.py``). Nothing of the JAX package is left
unported.
"""

from .config import (
    DEFAULT_HEIGHT,
    DEFAULT_WIDTH,
    KIND_COMPOSITE,
    KIND_ELLIPSE,
    KIND_POLYGON,
    MAX_COMPONENTS,
    MAX_OBJECTS,
    MODES,
    DataGenConfig,
    ModeSpec,
    disparity_mode,
    register_mode,
)
from .compose.render import (
    RenderOutput,
    WarpBank,
    prepare_atlas,
    render_batch,
    render_sample,
)
from .params.blueprint import Background, Objects, Primitives, Scene
from .params.sampler import sample_scene, sample_scene_batch
from .pipeline.generator import (
    Generator,
    generate_batch,
    make_generate_fn,
    make_mixed_generate_fn,
)
from .pipeline.sharding import distribute_atlas, texture_paths_for_process
from .texture_io import (
    TextureDB,
    atlas_for_config,
    build_texture_db,
    load_texture_db,
    procedural_atlas,
)

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_HEIGHT",
    "DEFAULT_WIDTH",
    "DataGenConfig",
    "ModeSpec",
    "MODES",
    "register_mode",
    "disparity_mode",
    "distribute_atlas",
    "texture_paths_for_process",
    "Generator",
    "Scene",
    "RenderOutput",
    "WarpBank",
    "generate_batch",
    "make_generate_fn",
    "make_mixed_generate_fn",
    "render_batch",
    "render_sample",
    "sample_scene",
    "sample_scene_batch",
    "TextureDB",
    "atlas_for_config",
    "build_texture_db",
    "load_texture_db",
    "prepare_atlas",
    "procedural_atlas",
]
