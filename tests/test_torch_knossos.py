"""KNOSSOS datasets and HDF5 files of the port against the JAX package.

The port carries jax-free copies of ``data/knossos_array.py``,
``data/_knossos_native.py`` with its C++ cube core, and ``h5save`` /
``h5load``. Each test writes with one package and reads with the other, or
reads the same files through both, and wants equal bytes: nothing here is
floating-point arithmetic. The error cases are those of
tests/test_data.py:323-660.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import write_knossos  # noqa: E402
from elektronn2_tpu.data import KnossosArray as JaxKnossosArray  # noqa: E402
from elektronn2_tpu.data.knossos_array import (  # noqa: E402
    KnossosArrayMulti as JaxKnossosArrayMulti,
    save_knossos as jax_save_knossos)
from elektronn2_tpu.utils.basic import (h5load as jax_h5load,  # noqa: E402
                                        h5save as jax_h5save)
from elektronn2_tpu_torch.data import _knossos_native  # noqa: E402
from elektronn2_tpu_torch.data.knossos_array import (  # noqa: E402
    KnossosArray, KnossosArrayMulti, save_knossos)
from elektronn2_tpu_torch.utils.basic import h5load, h5save  # noqa: E402

SLICES = [np.s_[:, :, :], np.s_[3:19, 2:14, 5:21], np.s_[5],
          np.s_[20:30, :, :], np.s_[-1], np.s_[2, -3, 1:5], np.s_[..., 4:9]]


@pytest.fixture
def native_lib():
    try:
        return _knossos_native.get_lib()
    except Exception:
        pytest.skip("no compiler for the native KNOSSOS core")


def _cube_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_knossos_read_by_the_other_package(rng, tmp_path, writer):
    vol = (rng.rand(10, 20, 12) * 255).astype(np.uint8)
    path = str(tmp_path / "ds")
    save = jax_save_knossos if writer == "jax" else save_knossos
    save(vol, path, exp_name="ds", cube_edge=8)
    reader = KnossosArray if writer == "jax" else JaxKnossosArray
    ka = reader(path, cube_edge=8)
    assert ka.shape == (10, 20, 12)
    np.testing.assert_array_equal(ka[:, :, :], vol)


def test_save_knossos_writes_the_same_files(rng, tmp_path):
    vol = (rng.rand(9, 17, 20) * 255).astype(np.uint8)
    jax_save_knossos(vol, str(tmp_path / "a"), exp_name="ds", cube_edge=8)
    save_knossos(vol, str(tmp_path / "b"), exp_name="ds", cube_edge=8)
    a, b = _cube_files(tmp_path / "a"), _cube_files(tmp_path / "b")
    assert sorted(a) == sorted(b) and len(a) > 1
    for k in a:
        assert a[k] == b[k], k
    with pytest.raises(ValueError, match="uint8"):
        save_knossos(vol.astype(np.float32), str(tmp_path / "c"))


@pytest.mark.parametrize("native", [False, True])
def test_reads_equal_the_jax_package(rng, tmp_path, native):
    if native:
        try:
            _knossos_native.get_lib()
        except Exception:
            pytest.skip("no compiler for the native KNOSSOS core")
    vol = (rng.rand(24, 16, 24) * 255).astype(np.uint8)
    path = write_knossos(tmp_path, vol)
    ka = KnossosArray(path, cube_edge=8, native=native, n_preload=2)
    ja = JaxKnossosArray(path, cube_edge=8, native=False)
    for a in (ka, ja):
        a.shape = (32, 16, 24)   # a missing z-cube layer: zeros
    for sl in SLICES:
        np.testing.assert_array_equal(ka[sl], ja[sl])
    np.testing.assert_array_equal(ka[:24], vol)
    np.testing.assert_array_equal(ka[24:32], 0)
    ka.preload([(0, 0, 0), (1, 1, 1)])
    np.testing.assert_array_equal(ka[0:8, 8:16, 8:16], vol[0:8, 8:16, 8:16])


def test_native_core_equals_numpy_path(rng, tmp_path, native_lib):
    vol = (rng.rand(24, 16, 24) * 255).astype(np.uint8)
    path = write_knossos(tmp_path, vol)
    ka_py = KnossosArray(path, cube_edge=8, native=False)
    ka_nat = KnossosArray(path, cube_edge=8, native=True)
    # max_ram=0: the cache floor of 8 cubes, so large reads stream through
    # the direct assembler
    ka_dir = KnossosArray(path, cube_edge=8, native=True, max_ram=0)
    for ka in (ka_py, ka_nat, ka_dir):
        ka.shape = (32, 16, 24)
    for sl in SLICES + [np.s_[1:31, 3:15, 2:23]]:
        np.testing.assert_array_equal(ka_nat[sl], ka_py[sl])
        np.testing.assert_array_equal(ka_dir[sl], ka_py[sl])
    assert ka_dir._max_cubes < 18 and len(ka_dir._cache) < 18


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_native_cubes_by_dtype(rng, tmp_path, native_lib, dtype):
    """The cube core against the numpy path and the JAX package's loader,
    per supported dtype; a missing file reads as zeros."""
    from elektronn2_tpu.data import _knossos_native as jax_native
    e = 8
    cubes = [(rng.rand(e, e, e) * 100).astype(dtype) for _ in range(3)]
    paths = []
    for i, c in enumerate(cubes):
        p = str(tmp_path / f"cube{i}.raw")
        c.transpose(0, 2, 1).tofile(p)            # stored (z, y, x)
        paths.append(p)
    paths.append(str(tmp_path / "missing.raw"))
    got = _knossos_native.load_cubes(paths, e, dtype)
    ref = jax_native.load_cubes(paths, e, dtype)
    for i, c in enumerate(cubes):
        np.testing.assert_array_equal(got[i], c)
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(got[3], 0)
    # a one-cube dataset of this dtype: KnossosArray's native and numpy
    # paths agree (and read the cube back)
    d = tmp_path / "ds" / "mag1" / "x0000" / "y0000" / "z0000"
    os.makedirs(d)
    cubes[2].transpose(0, 2, 1).tofile(
        str(d / "ds_mag1_x0000_y0000_z0000.raw"))
    (tmp_path / "ds" / "knossos.conf").write_text(
        'experiment name "ds";\nboundary x 8;\nboundary y 8;\n'
        'boundary z 8;\nedge length 8;\n')
    arrs = [KnossosArray(str(tmp_path / "ds"), dtype=dtype, native=n)
            for n in (False, True)]
    for sl in (np.s_[:, :, :], np.s_[1:7, 2, 3:8]):
        np.testing.assert_array_equal(arrs[1][sl], arrs[0][sl])
    np.testing.assert_array_equal(arrs[1][:, :, :], cubes[2])
    # disjoint placements (one clipped by a negative offset and the edge):
    # each voxel comes from one cube, the rest keeps its value
    out = np.full((10, 12, 9), 7, dtype)
    _knossos_native.assemble(paths[:2], [(0, 0, 0), (-3, 8, 1)], e, out)
    want = np.full((10, 12, 9), 7, dtype)
    want[0:8, 0:8, 0:8] = cubes[0]
    want[0:5, 8:12, 1:9] = cubes[1][3:8, 0:4, 0:8]
    np.testing.assert_array_equal(out, want)


def test_native_size_mismatch_raises(tmp_path, native_lib):
    p = tmp_path / "bad.raw"
    for n in (8 ** 3 - 1, 8 ** 3 + 1):
        p.write_bytes(b"\x00" * n)
        with pytest.raises(IOError, match="size mismatch"):
            _knossos_native.load_cubes([str(p)], 8, np.uint8)


def test_unsupported_dtype_takes_the_numpy_path(rng, tmp_path):
    vol = (rng.rand(8, 8, 8) * 255).astype(np.int64)
    path = write_knossos(tmp_path, vol.astype(np.uint8))
    cube_p = os.path.join(path, "mag1", "x0000", "y0000", "z0000",
                          "testds_mag1_x0000_y0000_z0000.raw")
    vol.transpose(0, 2, 1).tofile(cube_p)
    np.testing.assert_array_equal(
        KnossosArray(path, cube_edge=8, dtype=np.int64)[:, :, :], vol)
    with pytest.raises(TypeError, match="does not support dtype"):
        KnossosArray(path, cube_edge=8, dtype=np.int64, native=True)[:, :, :]
    with pytest.raises(ValueError, match="native"):
        KnossosArray(path, native="yes")


def test_index_errors_as_in_the_jax_package(rng, tmp_path):
    vol = (rng.rand(16, 16, 16) * 255).astype(np.uint8)
    path = write_knossos(tmp_path, vol, cube_edge=8)
    for cls in (KnossosArray, JaxKnossosArray):
        ka = cls(path)
        np.testing.assert_array_equal(ka[-1], vol[15])
        np.testing.assert_array_equal(ka[2, -3, 1:5], vol[2, 13, 1:5])
        for bad in (np.s_[16], np.s_[-17], np.s_[0, 16]):
            with pytest.raises(IndexError):
                ka[bad]
        with pytest.raises(IndexError, match="step-1"):
            ka[::2]


def test_shape_inference_ignores_stray_files(rng, tmp_path):
    vol = (rng.rand(16, 16, 16) * 255).astype(np.uint8)
    root = write_knossos(tmp_path, vol, cube_edge=8)
    (tmp_path / "testds" / "knossos.conf").write_text(
        'experiment name "testds";\nedge length 8;\nmagnification 1;\n')
    (tmp_path / "testds" / "mag1" / ".DS_Store").write_text("junk")
    (tmp_path / "testds" / "mag1" / "x0000" / "stray.txt").write_text("x")
    ka, ja = KnossosArray(root), JaxKnossosArray(root)
    assert ka.shape == ja.shape == (16, 16, 16)
    np.testing.assert_array_equal(ka[:, :, :], vol)
    with pytest.raises(FileNotFoundError):
        KnossosArray(str(tmp_path / "nothing_here"))


def test_multi_array_equals_the_jax_package(rng, tmp_path):
    vols = [(rng.rand(12, 10, 9) * 255).astype(np.uint8) for _ in range(2)]
    for i, v in enumerate(vols):
        save_knossos(v, str(tmp_path / f"ch{i}"), exp_name=f"ch{i}",
                     cube_edge=8)
    km = KnossosArrayMulti(str(tmp_path), ["ch0", "ch1"])
    jm = JaxKnossosArrayMulti(str(tmp_path), ["ch0", "ch1"])
    assert km.shape == jm.shape == (2, 12, 10, 9) and km.ndim == 4
    for sl in (np.s_[:, 1:9, 2:7, :], np.s_[1, 3:5], np.s_[..., 2:5]):
        np.testing.assert_array_equal(km[sl], jm[sl])
    np.testing.assert_array_equal(km[:, :, :, :], np.stack(vols))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_h5_files_read_by_the_other_package(rng, tmp_path, writer):
    pytest.importorskip("h5py")
    a = rng.rand(2, 5, 6).astype(np.float32)
    b = (rng.rand(3, 4) * 255).astype(np.uint8)
    save, load = ((jax_h5save, h5load) if writer == "jax"
                  else (h5save, jax_h5load))
    save({"prediction": a, "raw": b}, str(tmp_path / "d.h5"))
    save(a, str(tmp_path / "one.h5"), compress=False)
    got = load(str(tmp_path / "d.h5"), ["prediction", "raw"])
    np.testing.assert_array_equal(got[0], a)
    np.testing.assert_array_equal(got[1], b)
    assert got[1].dtype == np.uint8
    np.testing.assert_array_equal(load(str(tmp_path / "d.h5"), "raw"), b)
    np.testing.assert_array_equal(load(str(tmp_path / "one.h5")), a)
