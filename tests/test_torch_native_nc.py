"""The port's native (C++) NetCDF3 reader (``ltjax_torch.native``) against
scipy's ``netcdf_file``, after tests/test_native_nc.py: records, grid
variables and scalars bit-equal, with and without an eta row range
(one copy per level), in float32 and float64; ``NCFile`` picks the
native kind for a classic file and reads with it what ltjax's ``NCFile``
reads; ``RomsSeries(eta_slice=)`` gives the rows of the whole records
(v clamped to its shorter axis); a source that does not compile raises
with the compiler's output.  The library is built at first use into
build/ (no compiled file in the repository).
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from ltjax.io.nc import NCFile as JNCFile
from ltjax_torch import native, synth
from ltjax_torch.config import Config
from ltjax_torch.io.nc import NCFile
from ltjax_torch.io.roms import RomsSeries

RECORDS = ("zeta", "u", "v", "w", "AKs")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_natnc")
    case = synth.make_solid_body_case(nx=13, ny=11, us=5, lx=10e3, ly=8e3,
                                      h0=20.0, omega=1e-4, ramp_b=1e-5,
                                      dtype=torch.float64)
    gp, hp = synth.write_roms_files(case, str(d), n_records=6, dt=1800.0,
                                    records_per_file=3)
    return gp, hp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows", [None, (0, 11), (3, 7), (9, 10)],
                         ids=["whole", "all-rows", "middle", "last"])
def test_records_bit_equal_to_scipy(files, dtype, rows):
    _, hp = files
    n = native.NativeCDF(hp[0])
    with netcdf_file(hp[0], "r", mmap=False) as f:
        for name in RECORDS:
            for rec in range(3):
                want = np.asarray(f.variables[name][rec], dtype)
                if rows is not None:
                    ny_var = want.shape[-2]
                    lo, hi = min(rows[0], ny_var), min(rows[1], ny_var)
                    want = want[..., lo:hi, :]
                got = n.read(name, rec, dtype=dtype,
                             eta_slice=None if rows is None else (lo, hi))
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(n.read("ocean_time"),
                                      f.variables["ocean_time"][:])
    n.close()


def test_grid_and_scalars_bit_equal_to_scipy(files):
    gp, _ = files
    with native.NativeCDF(gp) as n, netcdf_file(gp, "r", mmap=False) as f:
        assert sorted(n.variables()) == sorted(f.variables)
        for name in f.variables:
            want = (f.variables[name].getValue()
                    if f.variables[name].shape == ()
                    else f.variables[name][:])
            np.testing.assert_array_equal(
                n.read(name), np.asarray(want, np.float64), err_msg=name)
        np.testing.assert_array_equal(
            n.read("h", eta_slice=(2, 5)),
            np.asarray(f.variables["h"][:], np.float64)[2:5])
        assert float(n.read("hc")) == float(f.variables["hc"].getValue())
        assert n.dims("h") == f.variables["h"].shape


def test_ncfile_prefers_native_and_matches_ltjax(files):
    gp, hp = files
    nc, jnc = NCFile(hp[1]), JNCFile(hp[1])
    assert nc.kind == "native"
    u = nc.read("u", 1, dtype="float32")
    assert u.dtype == np.float32 and u.shape == (5, 11, 12)
    for name in RECORDS:
        for es in (None, (2, 6)):
            np.testing.assert_array_equal(
                nc.read(name, 2, dtype="float32", eta_slice=es),
                jnc.read(name, 2, dtype="float32", eta_slice=es))
    assert nc.read_attr("u", "no_such_attr", "none") == "none"
    nc.close()
    jnc.close()
    g = NCFile(gp)
    assert g.kind == "native" and "h" in g.variables()
    g.close()


def test_series_strip_rows(files):
    gp, hp = files
    cfg = Config(us=5, ws=6, readAks=True)
    whole = RomsSeries(cfg, paths=hp)
    strip = RomsSeries(cfg, paths=hp, eta_slice=(6, 11))
    assert strip.reader == "native"
    for _ in range(4):                     # across the file boundary
        a, b = whole.next_record(), strip.next_record()
        assert a["time"] == b["time"]
        for k in ("zeta", "u", "w", "aks"):
            np.testing.assert_array_equal(b[k], a[k][..., 6:11, :])
        np.testing.assert_array_equal(b["v"], a["v"][..., 6:10, :])
    whole.close()
    strip.close()


def test_file_the_parser_refuses_is_read_by_scipy(files, monkeypatch):
    _, hp = files
    with NCFile(hp[0]) as nc:
        want = {k: nc.read(k, 1, dtype="float32", eta_slice=(1, 4))
                for k in RECORDS}

    def refuse(self, path):
        raise OSError(f"{path}: the native reader cannot parse it")

    monkeypatch.setattr(native.NativeCDF, "__init__", refuse)
    with NCFile(hp[0]) as nc:
        assert nc.kind == "cdf"
        for k in RECORDS:
            np.testing.assert_array_equal(
                nc.read(k, 1, dtype="float32", eta_slice=(1, 4)), want[k])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build(str(src))
    assert "error" in str(e.value)
    assert not os.listdir(tmp_path / "build")    # no partial library


@pytest.mark.parametrize("unlimited", [True, False],
                         ids=["record-dim", "fixed-dim"])
def test_record_and_fixed_leading_axes(tmp_path, unlimited):
    """A record read takes one slab of the leading axis whether it is the
    unlimited record dimension (records interleaved in the file) or a
    fixed one: equal to scipy's, rows too."""
    path = str(tmp_path / "t.nc")
    rng = np.random.default_rng(5)
    u = rng.normal(size=(3, 4, 7, 6)).astype(np.float32)
    z = rng.normal(size=(3, 7, 6))
    f = netcdf_file(path, "w")
    f.createDimension("t", None if unlimited else 3)
    for d, n in (("k", 4), ("eta", 7), ("xi", 6)):
        f.createDimension(d, n)
    f.createVariable("u", "f", ("t", "k", "eta", "xi"))[:] = u
    f.createVariable("zeta", "d", ("t", "eta", "xi"))[:] = z
    f.close()
    with native.NativeCDF(path) as n:
        for r in range(3):
            np.testing.assert_array_equal(n.read("u", r, "float32"), u[r])
            np.testing.assert_array_equal(n.read("zeta", r), z[r])
            np.testing.assert_array_equal(
                n.read("u", r, "float64", eta_slice=(2, 5)),
                u[r, :, 2:5].astype(np.float64))
        np.testing.assert_array_equal(n.read("u", dtype="float32"), u)
