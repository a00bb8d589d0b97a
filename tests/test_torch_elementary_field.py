"""The elementary field's CUDA kernel (flowgen_torch/csrc/fields.cu:
elementary_field_kernel) as far as the CPU reaches it:

* a CPU ``elementary_field`` runs the plain version and launches nothing;
* the constants the wrapper packs are ``_displacer_constants``' values in
  the kernel's order, and the wrapper refuses any other packing before it
  loads the library;
* the kernel's arithmetic, restated in float32 NumPy from the packed
  constants with the kernel's own float literals (read from fields.cu) and
  its staged ``f - 1`` and ``-b``, equals the plain version bit for bit.

The kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flowgen_torch.ops import detmath
from flowgen_torch.random.streams import Stream, root_key, stream_key
from flowgen_torch.warpfields import compose, fields

torch.set_num_threads(1)

FIELDS_CU = (Path(fields.__file__).resolve().parent.parent / "csrc"
             / "fields.cu")
F32 = np.float32


def _grids(big, n_fields, seed=7):
    grids, flags = [], []
    for i in range(n_fields):
        g = fields.sample_displacer_grid(
            stream_key(root_key(seed), Stream.WARP_FIELD, i), big)
        grids += [g, g]
        flags += [False, True]
    return fields.stack_grids(grids, flags)


def _bits(t):
    return np.ascontiguousarray(t).view(np.int32)


@pytest.mark.parametrize("big,size,stride", [(512, 256, 2.0), (400, 97, 1.0)])
def test_cpu_call_runs_plain_version(big, size, stride):
    grid, inv = _grids(big, 1)
    n0 = fields.elementary_field.launches
    got = fields.elementary_field(grid, size, inv, stride=stride)
    want = fields.elementary_field_plain(grid, size, inv, stride=stride)
    assert fields.elementary_field.launches == n0
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    with compose.plain_versions():
        again = fields.elementary_field(grid, size, inv, stride=stride)
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))


def test_packed_constants_follow_kernel_order():
    grid, inv = _grids(600, 2)
    M, N = grid.kind.shape
    packed = fields._packed_constants(grid, inv)
    assert packed.shape == (M, N, 14) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    consts = fields._displacer_constants(grid, inv)
    for j, name in enumerate(fields._KERNEL_CONSTANTS):
        want = consts[name].reshape(N, M).t().to(torch.float32)
        assert torch.equal(packed[..., j].view(torch.int32),
                           want.contiguous().view(torch.int32)), name
    assert set(fields._KERNEL_CONSTANTS) == set(consts)


@pytest.mark.parametrize("bad", ["float64", "strided", "rank", "width",
                                 "cpu"])
def test_wrapper_refuses_other_packings(bad):
    """Refused before any library is loaded: the CPU has none to load."""
    grid, inv = _grids(600, 1)
    consts = fields._packed_constants(grid, inv)
    consts = {"float64": consts.double(), "strided": consts.transpose(0, 1),
              "rank": consts.reshape(-1, 14), "width": consts[..., :13],
              "cpu": consts}[bad]
    with pytest.raises(ValueError):
        fields.elementary_field_cuda(consts, 64, 2.0)


def _cu_floats():
    """The kernel's float constants, by name, from fields.cu's literals."""
    src = FIELDS_CU.read_text()
    out = {}
    for name, lit in re.findall(
            r"constexpr float (k(?:Log2e|Ln2Hi|Ln2Lo|ExpC\d)) = ([^;]+)f;",
            src):
        out[name] = float.fromhex(lit)
    return out


def test_kernel_literals_are_detmath_roundings():
    k = _cu_floats()
    want = {"kLog2e": detmath._LOG2E, "kLn2Hi": detmath._LN2_HI,
            "kLn2Lo": detmath._LN2_LO,
            **{f"kExpC{i}": c for i, c in enumerate(detmath._EXP_C)}}
    assert set(k) == set(want)
    for name, v in want.items():
        assert k[name] == float(F32(v)), name


def _kernel_restated(consts, size, stride):
    """elementary_field_kernel's arithmetic in float32 NumPy: each block's
    staged record (f - 1, -b), the motion branch by kind, the support,
    det_exp with fields.cu's literals, the sums from +0 in index order."""
    k = {n: F32(v) for n, v in _cu_floats().items()}
    c = consts.numpy()
    M, N, _ = c.shape
    ys = np.arange(size, dtype=F32) * F32(stride)
    py, px = np.meshgrid(ys, ys, indexing="ij")

    def det_exp(x):
        x = np.where(x < F32(-87.0), F32(-87.0), x)
        kk = np.floor(x * k["kLog2e"] + F32(0.5))
        r = (x - kk * k["kLn2Hi"]) - kk * k["kLn2Lo"]
        p = np.full_like(r, k["kExpC0"])
        for i in range(1, 6):
            p = p * r + k[f"kExpC{i}"]
        e = (p * (r * r) + r) + F32(1.0)
        return e * ((kk.astype(np.int32) + 127).astype(np.uint32)
                    << 23).view(F32)

    out = np.zeros((M, 2, size, size), F32)
    for m in range(M):
        fx = np.zeros((size, size), F32)
        fy = np.zeros((size, size), F32)
        for j in range(N):
            kind, cx, cy, cs, sn, f, tx, ty, scx, scy, a, b, ratio, rinv = (
                c[m, j])
            fm1, nb = F32(f - F32(1.0)), F32(-b)
            if kind == 0:
                mx, my = tx, ty
            else:
                dx, dy = px - cx, py - cy
                if kind == 1:
                    mx = (cs * dx - sn * dy) - dx
                    my = (sn * dx + cs * dy) - dy
                else:
                    mx, my = fm1 * dx, fm1 * dy
            ex, ey = px - scx, py - scy
            rx = a * ex + b * ey
            ry = (nb * ex + a * ey) * ratio
            w = det_exp((-(rx * rx + ry * ry)) * rinv)
            fx = fx + mx * w
            fy = fy + my * w
        out[m, 0], out[m, 1] = fx, fy
    return out


@pytest.mark.parametrize("big,n_fields,size,stride", [
    (400, 2, 100, 2.0), (600, 1, 97, 1.0), (512, 1, 60, 2.0)])
def test_kernel_arithmetic_restated_matches_plain(big, n_fields, size,
                                                  stride):
    grid, inv = _grids(big, n_fields)
    assert set(torch.unique(grid.kind).tolist()) == {0, 1, 2}
    want = fields.elementary_field_plain(grid, size, inv, stride=stride)
    got = _kernel_restated(fields._packed_constants(grid, inv), size, stride)
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))
