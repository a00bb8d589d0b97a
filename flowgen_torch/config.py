"""Scene-recipe configuration: the 13 data-generation MODEs and the run config.

This is the TPU-native equivalent of the reference's mode registry and protobuf
config surface:

- the 13 hardcoded mode recipes (reference: src/caffe/DataGenerator.cpp:54-69 docs,
  1363-2001 per-mode RNG parameter wiring),
- ``DataGenerationParameter`` (reference: src/caffe/proto/caffe.proto:6-12) plus the
  relevant parts of Caffe's ``data_param`` (example-prototxt/train.prototxt:9-14).

Unlike the reference, output dimensions are run-time configuration rather than
compile-time ``#define``s (reference: include/caffe/data_generation/DataGenerator.h:55-56).

All distribution parameters below are transcribed from the per-mode switch in
``ObjectParametersGenerator``'s constructor (DataGenerator.cpp:1363-2001). Angles that
the reference feeds to AGG transforms are radians; the *background texture* rotation is
sampled in radians but consumed by CImg's ``rotate`` which takes degrees — we preserve
that quirk (see ``bg_tex_rot_is_degrees`` note in params/sampler.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

PI = math.pi

# Default output resolution (reference: DataGenerator.h:55-59, README.md:45).
DEFAULT_WIDTH = 512
DEFAULT_HEIGHT = 384

# Object-slot capacities for the fixed-shape (XLA-friendly) scene representation.
# The reference samples 16..24 foreground objects (DataGenerator.cpp:2832-2835,
# Uniform(16,24) truncated to int, so 16..23 occur) and 1..7 composite components
# (DataGenerator.cpp:2384, FixedRangeUniformInt(1,7)).
MAX_OBJECTS = 24
MAX_COMPONENTS = 7
MAX_SPOKES = 20          # FixedRangeUniformInt(3, 20) (DataGenerator.cpp:1395 etc.)
EDGE_SUBDIV = 6          # points per spoke-step when flattening outlines
MAX_EDGES = MAX_SPOKES * EDGE_SUBDIV  # 120 edge slots per polygon primitive
ELLIPSE_STEPS = 100      # agg::ellipse flattening (DataGenerator.cpp:1080)

# Object IDs mirror the reference's painter's-algorithm ordering:
# background id 1, foreground ids 10+i (data_generation_layer.cpp:202, 210).
BACKGROUND_OBJ_ID = 1
FOREGROUND_ID_BASE = 10

# Object kind codes (ObjType_t, DataGenerator.h:369-374).
KIND_ELLIPSE = 0
KIND_POLYGON = 1
KIND_COMPOSITE = 2


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """Distribution parameters for one scene-recipe mode.

    Field-by-field transcription of one ``case`` of the 13-way switch in
    ``ObjectParametersGenerator`` (DataGenerator.cpp:1363-2001). Ranges are
    ``(a, b)`` pairs; ``*_p`` fields are Trigger probabilities.
    """

    mode: int
    # Which object kinds RNG_ObjType chooses among (uniform choice).
    obj_types: Tuple[int, ...]
    # Background motion.
    bg_rot_p: float
    bg_rot_range: Tuple[float, float]          # GaussianSq, radians
    bg_trans_range: Tuple[float, float]        # Gaussian4, pixels
    bg_scale_p: float
    bg_scale_range: Tuple[float, float]        # GaussianSq
    # Foreground object motion.
    obj_trans_range: Tuple[float, float]       # Gaussian3, pixels
    obj_rot_p: float
    obj_rot_range: Tuple[float, float]         # GaussianSq, radians
    obj_scale_p: float
    obj_scale_range: Tuple[float, float]       # GaussianSq
    # Intrinsic pose.
    obj_init_rot_range: Tuple[float, float] = (-PI, PI)   # Uniform; (0,0) in mode 1
    # Shape recipe switches.
    axis_aligned_rect: bool = False   # mode 1: fixed 4-spoke rectangle
    allow_curves: bool = False        # Curve3 trigger active (modes 4-13)
    use_thin: bool = False            # thin-object logic consulted (modes 7, 9-13)
    warp_p: float = 0.0               # nonrigid deformation trigger (mode 9: 0.2)
    # Disparity-pair generation (the sibling capability of the IJCV paper's
    # framework; not in the reference repo, which is flow-only): motion is
    # constrained to horizontal translation — no rotation/scaling, zero
    # vertical components — so (image0, image1) form a rectified stereo pair
    # and disparity = -flow_x. See disparity_mode().
    horizontal_only: bool = False

    # --- Parameters identical across all 13 modes ---
    bg_init_rot_range: Tuple[float, float] = (-PI, PI)    # applied as DEGREES by CImg
    bg_init_scale_range: Tuple[float, float] = (0.8, 1.2)
    n_fg_range: Tuple[float, float] = (16.0, 24.0)        # Uniform, truncated to int
    obj_init_trans_margin: float = 50.0   # U(-W/2-50, 3W/2+50) x, U(-H/2-50, 3H/2+50) y
    ellipse_scale_range: Tuple[float, float] = (0.5, 2.0)  # x50 -> radii 25..100
    ellipse_radius_factor: float = 50.0
    spokes_range: Tuple[int, int] = (3, 20)
    dphi_range_deg: Tuple[float, float] = (-10.0, 10.0)
    spoke_r_range: Tuple[float, float] = (20.0, 80.0)
    poly_scale_range: Tuple[float, float] = (0.5, 2.0)
    curve_p: float = 0.33
    n_components_range: Tuple[int, int] = (1, 7)
    component_additive_p: float = 0.5
    component_offset_range: Tuple[float, float] = (-20.0, 20.0)
    comp_init_trans_range: Tuple[float, float] = (-15.0, 15.0)
    thin_p: float = 0.2
    thin_shrink: float = 0.05         # x-axis shrink of "needle" objects
    outline_shrink: float = 0.9       # inner shape of "outline" composites
    component_shrink: float = 0.2     # non-primary composite components
    generic_p: float = 0.5


def _deg(x: float) -> float:
    return x * PI / 180.0


def _base(mode: int, **kw) -> ModeSpec:
    return ModeSpec(mode=mode, **kw)


_EP = (KIND_ELLIPSE, KIND_POLYGON)
_EPC = (KIND_ELLIPSE, KIND_POLYGON, KIND_COMPOSITE)

MODES = {
    # 1 - axis-aligned rectangles, translation-only (DataGenerator.cpp:1364-1411)
    1: _base(
        1, obj_types=(KIND_POLYGON,),
        bg_rot_p=0.0, bg_rot_range=(0.0, 0.0), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.0, bg_scale_range=(1.0, 1.0),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.0, obj_rot_range=(0.0, 0.0),
        obj_scale_p=0.0, obj_scale_range=(1.0, 1.0),
        obj_init_rot_range=(0.0, 0.0),
        axis_aligned_rect=True,
    ),
    # 2 - straight-edged polygons, translation-only (cpp:1412-1459)
    2: _base(
        2, obj_types=(KIND_POLYGON,),
        bg_rot_p=0.0, bg_rot_range=(0.0, 0.0), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.0, bg_scale_range=(1.0, 1.0),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.0, obj_rot_range=(0.0, 0.0),
        obj_scale_p=0.0, obj_scale_range=(1.0, 1.0),
    ),
    # 3 - ellipses, translation-only (cpp:1460-1507)
    3: _base(
        3, obj_types=(KIND_ELLIPSE,),
        bg_rot_p=0.0, bg_rot_range=(0.0, 0.0), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.0, bg_scale_range=(1.0, 1.0),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.0, obj_rot_range=(0.0, 0.0),
        obj_scale_p=0.0, obj_scale_range=(1.0, 1.0),
    ),
    # 4 - ellipses + polygons (with curves), translation+rotation (cpp:1508-1555)
    4: _base(
        4, obj_types=_EP,
        bg_rot_p=0.3, bg_rot_range=(-_deg(10), _deg(10)), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.0, bg_scale_range=(1.0, 1.0),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.7, obj_rot_range=(-_deg(30), _deg(30)),
        obj_scale_p=0.0, obj_scale_range=(1.0, 1.0),
        allow_curves=True,
    ),
    # 5 - 4 + scaling motion (cpp:1556-1603)
    5: _base(
        5, obj_types=_EP,
        bg_rot_p=0.3, bg_rot_range=(-_deg(10), _deg(10)), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.6, bg_scale_range=(0.93, 1.07),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.7, obj_rot_range=(-_deg(30), _deg(30)),
        obj_scale_p=0.7, obj_scale_range=(0.8, 1.2),
        allow_curves=True,
    ),
    # 6 - 5 + composite objects with holes (cpp:1604-1653)
    6: _base(
        6, obj_types=_EPC,
        bg_rot_p=0.3, bg_rot_range=(-_deg(10), _deg(10)), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.6, bg_scale_range=(0.93, 1.07),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.7, obj_rot_range=(-_deg(30), _deg(30)),
        obj_scale_p=0.7, obj_scale_range=(0.8, 1.2),
        allow_curves=True,
    ),
    # 7 - 6 + thin "needle"/"outline" objects (cpp:1654-1703)
    7: _base(
        7, obj_types=_EPC,
        bg_rot_p=0.3, bg_rot_range=(-_deg(10), _deg(10)), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.6, bg_scale_range=(0.93, 1.07),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.7, obj_rot_range=(-_deg(30), _deg(30)),
        obj_scale_p=0.7, obj_scale_range=(0.8, 1.2),
        allow_curves=True, use_thin=True,
    ),
    # 8 - shapes of 4 but translation-only (cpp:1704-1751)
    8: _base(
        8, obj_types=_EP,
        bg_rot_p=0.0, bg_rot_range=(0.0, 0.0), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.0, bg_scale_range=(1.0, 1.0),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.0, obj_rot_range=(0.0, 0.0),
        obj_scale_p=0.0, obj_scale_range=(1.0, 1.0),
        allow_curves=True,
    ),
    # 9 - 7 + nonrigid deformations (cpp:1752-1801)
    9: _base(
        9, obj_types=_EPC,
        bg_rot_p=0.3, bg_rot_range=(-_deg(10), _deg(10)), bg_trans_range=(-40.0, 40.0),
        bg_scale_p=0.6, bg_scale_range=(0.93, 1.07),
        obj_trans_range=(-120.0, 120.0),
        obj_rot_p=0.7, obj_rot_range=(-_deg(30), _deg(30)),
        obj_scale_p=0.7, obj_scale_range=(0.8, 1.2),
        allow_curves=True, use_thin=True, warp_p=0.2,
    ),
    # 10 - 7 with halved motion magnitudes (cpp:1802-1852)
    10: _base(
        10, obj_types=_EPC,
        bg_rot_p=0.176, bg_rot_range=(-_deg(5), _deg(5)), bg_trans_range=(-20.0, 20.0),
        bg_scale_p=0.429, bg_scale_range=(0.965, 1.035),
        obj_trans_range=(-60.0, 60.0),
        obj_rot_p=0.539, obj_rot_range=(-_deg(15), _deg(15)),
        obj_scale_p=0.539, obj_scale_range=(0.9, 1.1),
        allow_curves=True, use_thin=True,
    ),
    # 11 - 7 with doubled motion magnitudes (cpp:1853-1902)
    11: _base(
        11, obj_types=_EPC,
        bg_rot_p=0.462, bg_rot_range=(-_deg(20), _deg(20)), bg_trans_range=(-80.0, 80.0),
        bg_scale_p=0.75, bg_scale_range=(0.86, 1.14),
        obj_trans_range=(-240.0, 240.0),
        obj_rot_p=0.824, obj_rot_range=(-_deg(60), _deg(60)),
        obj_scale_p=0.824, obj_scale_range=(0.6, 1.4),
        allow_curves=True, use_thin=True,
    ),
    # 12 - 7 with thirded motion magnitudes (cpp:1903-1952)
    12: _base(
        12, obj_types=_EPC,
        bg_rot_p=0.125, bg_rot_range=(-_deg(3.3), _deg(3.3)),
        bg_trans_range=(-13.3, 13.3),
        bg_scale_p=0.333, bg_scale_range=(0.976, 1.023),
        obj_trans_range=(-40.0, 40.0),
        obj_rot_p=0.437, obj_rot_range=(-_deg(10), _deg(10)),
        obj_scale_p=0.437, obj_scale_range=(0.933, 1.066),
        allow_curves=True, use_thin=True,
    ),
    # 13 - 7 with tripled motion magnitudes (cpp:1953-2002)
    13: _base(
        13, obj_types=_EPC,
        bg_rot_p=0.563, bg_rot_range=(-_deg(30), _deg(30)),
        bg_trans_range=(-120.0, 120.0),
        bg_scale_p=0.818, bg_scale_range=(0.79, 1.21),
        obj_trans_range=(-360.0, 360.0),
        obj_rot_p=0.875, obj_rot_range=(-_deg(90), _deg(90)),
        obj_scale_p=0.875, obj_scale_range=(0.4, 1.6),
        allow_curves=True, use_thin=True,
    ),
}


def disparity_mode(base_mode: int = 7, mode_id: int = None) -> int:
    """Register (or return) a disparity variant of ``base_mode``: the same
    shape/texture/placement recipe with motion restricted to horizontal
    translation. Generated batches then satisfy the rectified-stereo
    constraint (flow_y == 0 everywhere) and carry a ``disparity`` output
    (= -flow_x). Default ids: 100 + base_mode."""
    if mode_id is None:
        mode_id = 100 + base_mode
    if mode_id in MODES:
        return mode_id
    base = MODES[base_mode]
    spec = dataclasses.replace(
        base,
        mode=mode_id,
        horizontal_only=True,
        bg_rot_p=0.0, bg_scale_p=0.0,
        obj_rot_p=0.0, obj_scale_p=0.0,
        warp_p=0.0,
    )
    MODES[mode_id] = spec
    return mode_id


def register_mode(spec: ModeSpec) -> int:
    """Register a custom scene recipe under ``spec.mode``.

    The reference's extension story was "add a case to the 13-way switch and
    recompile" (README.md:42, DataGenerator.cpp:1363); here a mode is plain
    data — construct a :class:`ModeSpec` (``dataclasses.replace`` of an
    existing one is the easiest start) and register it. Returns the mode id.
    """
    if spec.mode in MODES:
        raise ValueError(f"mode {spec.mode} already registered")
    MODES[spec.mode] = spec
    return spec.mode


@dataclasses.dataclass(frozen=True)
class DataGenConfig:
    """Run configuration — TPU-native replacement for ``DataGenerationParameter``
    (src/caffe/proto/caffe.proto:6-12) + Caffe ``data_param`` (train.prototxt:9-14).

    Thread-count knobs from the reference have no analog (generation is a single
    fused device program); ``prefetch`` keeps its meaning as pipeline depth for the
    host-side iterator.
    """

    mode: int = 1
    batch_size: int = 8
    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    use_antialiasing: bool = True         # proto field use_antialiasing (default true)
    texture_dbases: Tuple[str, ...] = ()  # list files of texture image paths
    # Preserve heterogeneous source resolutions (reference crop geometry is
    # per-source, Texture::getRandomizedCrop cpp:87-109). Fused path only;
    # plain arrays / the windowed fallback keep the canonical 2Hx2W resize.
    native_texture_fov: bool = True
    prefetch: int = 2                     # device-step pipelining depth
    seed: int = 0
    # Output compatibility switches (reference emits 0-255 BGR CHW float batches,
    # data_generation_layer.cpp:128-130 + BGR swap at DataGenerator.cpp:129-131).
    channel_order: str = "rgb"            # "rgb" or "bgr"
    layout: str = "nhwc"                  # "nhwc" (TPU-native) or "nchw" (Caffe)
    compute_inverse_flow: bool = False    # RenderCore::computeFlowImage(inverse=true)
    # Optional per-pixel supervision masks (fused path only): "occlusion"
    # (frame-0 pixels whose target is covered by a different object or leaves
    # the frame) and "motion_boundary" (index-image discontinuities). The
    # painter's pass knows the winning object per pixel, so these are nearly
    # free; the reference has no equivalent output.
    emit_masks: bool = False
    # Photometric augmentation fused into the step (ops/photometric.py):
    # FlowNet-recipe color/gamma/brightness/contrast jitter shared across the
    # pair (flow stays valid) + independent per-frame sensor noise. The
    # reference emits raw renders and left this to separate Caffe layers.
    photometric_augment: bool = False
    # Warp-field bank sizing (mode 9); see flowgen/warpfields/generator.py.
    # None derives max(2, batch_size // 16), which keeps per-crop reuse at
    # ~9x per bank epoch INDEPENDENT of batch size at 512x384 (the reference
    # serves each crop 3x from continuously-produced fields,
    # WarpFields.cpp:516-538; tests/test_warpfields.py pins the reuse bound).
    # Affordable because the bank composes through the banded Mosaic kernels
    # on TPU (warpfields/pallas_fields.py), ~10x cheaper than dense gathers.
    # Note the sharded path replaces batch_size AFTER this resolves
    # (pipeline/sharding.py), so the bank stays global and mode-9 content is
    # device-count invariant.
    warp_fields_per_batch: int | None = None
    # Regenerate the warp-crop bank every N steps (the reference amortizes its
    # expensive 1536^2 composed fields by reusing each crop 3x across a shared
    # queue, WarpFields.cpp:516-538; keying the bank by step//N is the
    # deterministic analog).
    warp_bank_reuse_steps: int = 2
    max_objects: int = MAX_OBJECTS
    dtype: str = "float32"
    # Per-object windowed evaluation (bbox-culled coverage/blend/gather).
    # Results are identical to full-frame evaluation; disable only to
    # cross-check or debug (see tests/test_render.py).
    windowed: bool = True
    # Pallas polygon-coverage kernel (edge-count-culled, fused). "auto" uses
    # it on TPU backends and the pure-XLA path on CPU; "always"/"never" force.
    use_pallas: str = "auto"
    # Render implementation = the IMAGE content contract. The reference has
    # exactly one frame-rendering implementation (DataGenerator.cpp:337-349,
    # 762-818), so a given (seed, step, cfg) means one set of image bytes;
    # mirroring that, "fused" (default) routes every backend through the
    # scene megakernel (compose/fused.py; Pallas interpret mode off-TPU, the
    # mode tests' configuration) — the same (seed, step, cfg) yields the same
    # frames everywhere up to backend fma rounding at u8 .5 boundaries
    # (PALLAS_CHECK mosaic-vs-interpret: 0 pixels >= 2 levels apart).
    # "windowed" forces the bbox-culled XLA path (compose/render.py) — a
    # debug/fallback renderer whose frames are NOT content-contractual (its
    # quad-gather resampling chain differs sub-level almost everywhere,
    # ~1e-3 px flow-identical); also taken automatically when the megakernel
    # is ineligible (non-(8,128)-aligned frames, custom modes outside the
    # two-pass envelope, full-frame windowed=False). "auto" is the pre-r5
    # backend-keyed selection (fused on TPU, windowed on CPU): fastest CPU
    # throughput, no cross-backend image contract. Flow is path-invariant
    # (bit-exact) under every setting.
    render_impl: str = "fused"
    # Warp-bank implementation = the mode-9 CONTENT contract. The bank IS
    # generated content (every deforming object samples it), so its
    # implementation must not follow the runtime backend or the same
    # (seed, step) would mean different scenes on CPU vs TPU. "pallas"
    # (default): the banded Mosaic composition (warpfields/pallas_fields.py),
    # run in interpret mode off-TPU so every backend produces the stream the
    # TPU path produces. "xla": the quad-gather composition
    # (warpfields/fields.make_big_field) — ~5x faster on CPU at production
    # size but a DIFFERENT stream (sub-2% field deviation,
    # tests/test_pallas_fields.py); switching this dial changes all mode-9
    # content for a given seed. The reference has exactly one implementation
    # (WarpFields.cpp:337-437); this mirrors that with "pallas".
    warp_bank_impl: str = "pallas"
    # Out-of-bounds warp-field semantics (nonrigid modes). The reference
    # leaves signaling NaNs at warp-field pixels whose composed flow left the
    # big field (WarpFields.cpp:389-398, 425-434), and those NaNs propagate
    # into emitted flow through getPointFlow's bilinear sample (cpp:398-406).
    # "zero" (default): flagged pixels sample as zero displacement, so
    # training data stays finite (ROADMAP deviation #6). "nan": flagged
    # pixels poison the emitted FORWARD flow like the reference's — consumers
    # that mask their loss on invalid flow see NaN where the reference emits
    # NaN (tests/test_warpfields.py pins the footprint against the oracle).
    # Mask/texture warping through the INVERSE field samples zero displacement
    # in both settings: the reference feeds those NaNs to CImg linear_atXY
    # coordinates — an out-of-range read, not a contract. Note the stock crop
    # tiling keeps >= W/4 margins from the big-field border
    # (WarpFields.cpp:619-634) while composed displacements are sub-3 px, so
    # stock banks carry no flags at all; the dial matters for user-supplied
    # banks and custom field geometries.
    warp_oob: str = "zero"
    # Runtime guard (fused path): per batch, count scene elements whose
    # ACTUAL frame-1 sampling affine exceeds the statically-sized resample
    # envelope — possible only if a custom mode's shapers escape their
    # declared ModeSpec ranges — and emit a device-side warning
    # (compose/fused.envelope_violations). "auto": on for custom-registered
    # modes, off for the built-in ids, whose shapers provably close over
    # their ranges (DataGenerator.cpp:826-921). "always"/"never" force.
    validate_envelope: str = "auto"

    def __post_init__(self):
        if self.warp_fields_per_batch is None:
            object.__setattr__(
                self, "warp_fields_per_batch", max(2, self.batch_size // 16)
            )
        if self.mode not in MODES:
            if 101 <= self.mode <= 113 and (self.mode - 100) in MODES:
                disparity_mode(self.mode - 100)   # auto-register 10x ids
            else:
                raise ValueError(
                    f"BAD MODE {self.mode}; valid modes are 1..13, "
                    "registered customs, or 10x disparity variants"
                )
        if self.channel_order not in ("rgb", "bgr"):
            raise ValueError("channel_order must be 'rgb' or 'bgr'")
        if self.layout not in ("nhwc", "nchw"):
            raise ValueError("layout must be 'nhwc' or 'nchw'")
        if self.render_impl not in ("fused", "windowed", "auto"):
            raise ValueError("render_impl must be 'fused', 'windowed', or "
                             "'auto'")
        if self.warp_bank_impl not in ("pallas", "xla"):
            raise ValueError("warp_bank_impl must be 'pallas' or 'xla'")
        if self.warp_oob not in ("zero", "nan"):
            raise ValueError("warp_oob must be 'zero' or 'nan'")

    @property
    def mode_spec(self) -> ModeSpec:
        return MODES[self.mode]
