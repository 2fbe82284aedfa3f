"""The port's file readers and writers (config, .mol2, .xyz, .cfpfh, output
files, BO1 pair lists, legacy layouts) and geometry helpers vs the JAX
package's, on the same files written in tmp_path: equal values, and
byte-equal files where both write one.  The port parses .mol2 and float
tables with its native parsers only; they are held equal to the JAX
package's Python parsers."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from goicp_tpu import config as jconfig
from goicp_tpu import native as jnative
from goicp_tpu.chem import properties as jprops
from goicp_tpu.geom import rmsd as jrmsd
from goicp_tpu.geom import transform as jtransform
from goicp_tpu.io import cfpfh as jcfpfh
from goicp_tpu.io import legacy as jlegacy
from goicp_tpu.io import mol2 as jmol2
from goicp_tpu.io import output as joutput
from goicp_tpu.io import tsv as jtsv
from goicp_tpu.io import xyz as jxyz
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.bench import bo1_files
from goicp_tpu_torch.chem import properties as tprops
from goicp_tpu_torch.geom import rmsd as trmsd
from goicp_tpu_torch.geom import transform as ttransform
from goicp_tpu_torch.io import cfpfh as tcfpfh
from goicp_tpu_torch.io import legacy as tlegacy
from goicp_tpu_torch.io import mol2 as tmol2
from goicp_tpu_torch.io import output as toutput
from goicp_tpu_torch.io import tsv as ttsv
from goicp_tpu_torch.io import xyz as txyz

torch.set_num_threads(1)


@pytest.fixture
def jax_python_parsers(monkeypatch):
    """The JAX package's readers with its native library switched off, so
    they take their Python parsers."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-40.0, 90.0, size=(n, 3)), 6),
            rng.integers(0, 9, size=n))


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_config_file_matches_jax(tmp_path):
    path = tmp_path / "config.txt"
    path.write_text("# reference-style config\n"
                    "MSEThresh=0.02  # per point\n"
                    "norm 1\n"
                    "rot_batch;4\n"
                    "trans_capacity=64.0\n"
                    "trimFraction = 0.1\n"
                    "notAKey=3\n\n"
                    "margin_frac=0.9\n")
    assert tconfig.parse_config_file(str(path)) == \
        jconfig.parse_config_file(str(path))
    t, j = tconfig.GoICPConfig.from_file(str(path)), \
        jconfig.GoICPConfig.from_file(str(path))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.norm, t.rot_batch, t.trans_capacity) == (1, 4, 64)


def test_config_writer_round_trips(tmp_path):
    cfg = dataclasses.replace(tconfig.GoICPConfig(), MSEThresh=0.0123,
                              rot_frontier_capacity=1000, margin_frac=0.9)
    path = str(tmp_path / "config.txt")
    bo1_files.write_config(path, cfg)
    assert tconfig.GoICPConfig.from_file(path) == cfg
    assert dataclasses.asdict(jconfig.GoICPConfig.from_file(path)) == \
        dataclasses.asdict(cfg)


@pytest.mark.parametrize("bad", [dict(norm=3), dict(cfpfh=4),
                                 dict(distTransSize=1),
                                 dict(trimFraction=1.0)])
def test_config_validation_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        tconfig.GoICPConfig.from_dict({k: str(v) for k, v in bad.items()})
    with pytest.raises(AssertionError):
        jconfig.GoICPConfig.from_dict({k: str(v) for k, v in bad.items()})


def test_properties_match_jax():
    assert tprops.PROP_NAMES == jprops.PROP_NAMES
    assert tprops.RMSD_PROPS == jprops.RMSD_PROPS
    for name in [*jprops.PROP_NAMES, "XX", "", "CB"]:
        assert tprops.string_to_prop(name) == jprops.string_to_prop(name)


def test_mol2_writer_is_the_tools_writer(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import ref_workload_baseline as tools
    finally:
        sys.path.pop(0)
    coords, props = _cloud(1, 23)
    bo1_files.write_mol2(str(tmp_path / "a.mol2"), coords, props)
    tools._write_mol2(str(tmp_path / "b.mol2"), coords, props)
    assert _bytes(tmp_path / "a.mol2").replace(b"a.mol2", b"b.mol2") == \
        _bytes(tmp_path / "b.mol2")
    bo1_files.write_cfpfh(str(tmp_path / "a.cfpfh"), 5)
    tools._write_cfpfh(str(tmp_path / "b.cfpfh"), 5)
    assert _bytes(tmp_path / "a.cfpfh") == _bytes(tmp_path / "b.cfpfh")


@pytest.mark.parametrize("n", [1, 17, 64])
def test_mol2_readers_match_jax(tmp_path, n, jax_python_parsers):
    coords, props = _cloud(n, n)
    path = str(tmp_path / "cav_cavity6.mol2")
    bo1_files.write_mol2(path, coords, props)
    tc, tp = tmol2.read_mol_file(path)        # native
    jc, jp = jmol2.read_mol_file(path)        # Python (native switched off)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tp, jp)
    assert tc.dtype == jc.dtype and tp.dtype == jp.dtype
    np.testing.assert_array_equal(tc, coords)
    np.testing.assert_array_equal(tmol2.get_atom_block(path),
                                  jmol2.get_atom_block(path))
    assert tmol2.mol2_atom_count(path) == jmol2.mol2_atom_count(path) == n


def test_native_mol2_parser_matches_python_on_tabs_and_long_names(
        tmp_path, jax_python_parsers):
    """Tab-separated rows (as apply_transform_protein writes them), names
    longer than the native parser's 7 bytes, blank lines, a trailing
    section."""
    path = str(tmp_path / "p.mol2")
    with open(path, "w") as fh:
        fh.write("@<TRIPOS>MOLECULE\nx\n@<TRIPOS>ATOM\n"
                 "1\tCA\t1.5\t-2.25\t3.0\tC.3\t1\tALA\t0.0\n\n"
                 "2 N 0.125 4 -5 N.am 1 ALA 0.0\n"
                 "3 OD1 7.0 8.0 9.0 O.2 1 ASP 0.0\n"
                 "4 CZXYZWV 1 1 1 C.ar 1 PHE 0.0\n"
                 "@<TRIPOS>BOND\n1 1 2 1\n")
    for a, b in zip(tmol2.read_mol_file(path), jmol2.read_mol_file(path)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmol2.get_atom_block(path),
                                  jmol2.get_atom_block(path))


def test_apply_transform_protein_byte_equal(tmp_path):
    coords, props = _cloud(5, 30)
    src = str(tmp_path / "prot.mol2")
    bo1_files.write_mol2(src, coords, props)
    R = rodrigues_np(np.array([0.3, -1.2, 2.0]))
    t = np.array([1.5, -20.25, 3.125])
    tmol2.apply_transform_protein(src, str(tmp_path / "t.mol2"), R, t)
    jmol2.apply_transform_protein(src, str(tmp_path / "j.mol2"), R, t)
    assert _bytes(tmp_path / "t.mol2") == _bytes(tmp_path / "j.mol2")
    np.testing.assert_allclose(tmol2.read_mol_file(str(tmp_path / "t.mol2"))
                               [0], coords @ R.T + t, atol=1e-6)


def test_xyz_round_trip_matches_jax(tmp_path):
    coords, props = _cloud(7, 20)
    coords = coords / 97.0
    for name, p in (("with.xyz", props), ("without.xyz", None)):
        txyz.write_normalized_cloud(str(tmp_path / f"t_{name}"), coords, p)
        jxyz.write_normalized_cloud(str(tmp_path / f"j_{name}"), coords, p)
        assert _bytes(tmp_path / f"t_{name}") == _bytes(tmp_path / f"j_{name}")
    (tmp_path / "raw.xyz").write_text(
        "0.5 -0.25 1.0\n0.125 0.75 -1.0 3\n\n-0.5 0.5 0.5\n")
    (tmp_path / "cut.txt").write_text("2\n1 2 3\n4 5 6\n7 8 9\n")
    for name in ("t_with.xyz", "t_without.xyz", "raw.xyz", "cut.txt"):
        tc, tp = txyz.read_point_cloud(str(tmp_path / name))
        jc, jp = jxyz.read_point_cloud(str(tmp_path / name))
        np.testing.assert_array_equal(tc, jc)
        assert (tp is None) == (jp is None)
        if tp is not None:
            np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(
        txyz.read_point_cloud(str(tmp_path / "t_with.xyz"))[0],
        txyz.quantize_like_file(coords))


def test_cfpfh_matches_jax(tmp_path, jax_python_parsers):
    rng = np.random.default_rng(8)
    desc = np.round(rng.uniform(0, 60, size=(9, 41)), 4)
    path = str(tmp_path / "c_cavity6.cfpfh")
    np.savetxt(path, desc, fmt="%.4f")
    np.testing.assert_array_equal(tcfpfh.read_cfpfh(path),
                                  jcfpfh.read_cfpfh(path))
    np.testing.assert_array_equal(tcfpfh.read_cfpfh(path), desc)
    bad = str(tmp_path / "bad.cfpfh")
    np.savetxt(bad, desc[:, :40], fmt="%.4f")
    with pytest.raises(ValueError):
        tcfpfh.read_cfpfh(bad)
    with pytest.raises(ValueError):
        jcfpfh.read_cfpfh(bad)
    for cav in ("cavitiesN/2x86_3_cavity6_sim1N.xyz",
                "cavities/2x86_3_cavity6.mol2", "x/a_b_c.xyz"):
        assert tcfpfh.cfpfh_path_for_cavity("cf", cav) == \
            jcfpfh.cfpfh_path_for_cavity("cf", cav)


def test_native_float_table_matches_jax_native(tmp_path):
    path = str(tmp_path / "f.txt")
    with open(path, "w") as fh:
        fh.write("1.5 -2e-3\n\t3 4.25e+2\n  end 7\n")
    from goicp_tpu_torch import native as tnative
    got = tnative.parse_float_table(path, 100)
    np.testing.assert_array_equal(got, [1.5, -2e-3, 3.0, 425.0])
    if jnative.available():
        np.testing.assert_array_equal(got,
                                      jnative.parse_float_table(path, 100))
    np.testing.assert_array_equal(tnative.parse_float_table(path, 2),
                                  [1.5, -2e-3])
    with pytest.raises(OSError):
        tnative.parse_float_table(str(tmp_path / "missing"), 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_output_files_byte_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    R = rodrigues_np(rng.uniform(-3, 3, 3))
    t = rng.normal(size=3) * (10.0 if seed else 1e-4)
    err, secs = float(rng.uniform(0, 50)), float(rng.uniform(0, 3))
    for name, tw, jw, args in (
            ("out.txt", toutput.write_output, joutput.write_output,
             (secs, R, t, err, int(rng.integers(0, 300)))),
            ("out_rescaled.txt", toutput.write_rescaled,
             joutput.write_rescaled, (secs, R, t, err))):
        tw(str(tmp_path / f"t_{name}"), *args)
        jw(str(tmp_path / f"j_{name}"), *args)
        assert _bytes(tmp_path / f"t_{name}") == _bytes(tmp_path / f"j_{name}")
        tr = toutput.read_output(str(tmp_path / f"t_{name}"))
        jr = joutput.read_output(str(tmp_path / f"t_{name}"))
        assert tr.keys() == jr.keys()
        for k in tr:
            np.testing.assert_array_equal(tr[k], jr[k])


def test_pair_list_and_legacy_readers_match_jax(tmp_path):
    tsv = tmp_path / "cavities_similar_BO1_clean.tsv"
    tsv.write_text("P1\tP2\t2x86_3\t1eq2_6\t0.9\tfam\t1\n"
                   "P3 P4 2ktd_1 4imo_2 0.8 fam 2\n\nP5\tP6\tx\ty\t1\tf\t3\n")
    assert ttsv.read_pair_list(str(tsv)) == jtsv.read_pair_list(str(tsv)) \
        == [("2x86_3", "1eq2_6"), ("2ktd_1", "4imo_2")]
    pcd = tmp_path / "c.pcd"
    pcd.write_text("".join(f"# header {i}\n" for i in range(10))
                   + "1.0 2.0 3.0 30894\n4 5 6 1.0\nbad row\n")
    for a, b in zip(tlegacy.read_pcd_file(str(pcd)),
                    jlegacy.read_pcd_file(str(pcd))):
        np.testing.assert_array_equal(a, b)
    readme = tmp_path / "readme.txt"
    readme.write_text("".join(f"h{i}\n" for i in range(11))
                      + "a\tb\nc \t d\n\nsep\ne\tf\n\ng\th\n")
    assert tlegacy.read_config_protein_file(str(readme)) == \
        jlegacy.read_config_protein_file(str(readme))
    mols = tmp_path / "mols.tsv"
    mols.write_text("u\tv\t2x86_3\t1eq2_6\tx\nshort\trow\n\nu\tv\tq\tr\n")
    assert tlegacy.read_config_mol_file(str(mols)) == \
        jlegacy.read_config_mol_file(str(mols))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(12, 3))
    R = rodrigues_np(rng.uniform(-3, 3, 3))
    t = rng.normal(size=3)
    np.testing.assert_array_equal(ttransform.apply_rigid(pts, R, t),
                                  jtransform.apply_rigid(pts, R, t))
    args = (R, t, 12.5, rng.normal(size=3), rng.normal(size=3))
    for a, b in zip(ttransform.rescale_transform(*args),
                    jtransform.rescale_transform(*args)):
        np.testing.assert_array_equal(a, b)
    other = pts + rng.normal(size=pts.shape) * 0.1
    assert trmsd.rmsd(pts, other) == jrmsd.rmsd(pts, other)
    with pytest.raises(ValueError):
        trmsd.rmsd(pts, other[:5])
