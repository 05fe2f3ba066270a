"""PyTorch port, its own ``config`` and ``io`` held against the JAX
package's: one config text parsed by both gives equal fields, a cloud
written by either ``write_pcd`` is read identically by the other's
``read_pcd``, every ``formats`` writer produces byte-equal files from the
same arrays, and ``scan_epoch_folder`` agrees on a folder."""

import dataclasses

import numpy as np
import pytest

import piecewise_icp_tpu.config as jconfig
import piecewise_icp_tpu.io as jio
from piecewise_icp_tpu.utils.errors import FileFormatError as JFileFormatError

import piecewise_icp_torch.config as tconfig
import piecewise_icp_torch.io as tio
from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.utils.errors import FileFormatError

# only the JAX package reads these (backend and kernel selection,
# static-shape padding)
JAX_ONLY = {"backend", "nn_impl", "segmentation_impl", "point_pad_multiple",
            "patch_pad_multiple"}

CONFIG_TEXT = """string FolderFilePath1: /data/scans/
string FolderFilePath2: /data/out/
bool isSetResSVsize (yes-1, no-0): 1
float PCres1 (m): 0.0125
float PCres2 (m): 0.015
float SVsize1 (m): 0.11
float SVsize2 (m): 0.13
bool isSetDTinit (yes-1, no-0): 0
float DTinit (m): 0.07
float DTmin (m): 0.003
bool isVisual (yes-1, no-0): 0"""


class TestConfig:
    def test_same_text_same_fields(self, tmp_path):
        conf = tmp_path / "config.txt"
        conf.write_text(CONFIG_TEXT)
        jc = jconfig.PiecewiseICPConfig.from_reference_file(conf)
        tc = tconfig.PiecewiseICPConfig.from_reference_file(conf)
        assert dataclasses.asdict(tc) == dataclasses.asdict(config_from_jax(jc))
        assert (tc.res2, tc.svsize1, tc.set_dtinit, tc.dt_min) \
            == (0.015, 0.11, False, 0.003)
        # overrides go through both parsers alike
        jc = jconfig.PiecewiseICPConfig.from_reference_file(
            conf, kalman_enabled=True, guard_enabled=False)
        tc = tconfig.PiecewiseICPConfig.from_reference_file(
            conf, kalman_enabled=True, guard_enabled=False)
        assert tc == config_from_jax(jc)

    def test_fields_and_defaults_are_the_twins(self):
        jf = {f.name: f for f in dataclasses.fields(jconfig.PiecewiseICPConfig)}
        tf = {f.name: f for f in dataclasses.fields(tconfig.PiecewiseICPConfig)}
        assert set(jf) - set(tf) == JAX_ONLY
        assert set(tf) <= set(jf)
        assert tconfig.PiecewiseICPConfig() \
            == config_from_jax(jconfig.PiecewiseICPConfig())
        assert tconfig.ARC_TO_GON == jconfig.ARC_TO_GON

    def test_written_config_is_byte_equal(self, tmp_path):
        jc = jconfig.PiecewiseICPConfig(path1="a/", path2="b/", res1=0.01,
                                        set_dtinit=False)
        jc.to_reference_file(tmp_path / "j.txt")
        config_from_jax(jc).to_reference_file(tmp_path / "t.txt")
        assert (tmp_path / "j.txt").read_bytes() \
            == (tmp_path / "t.txt").read_bytes()

    @pytest.mark.parametrize("bad", [dict(res1=-1.0), dict(svsize1=5.0),
                                     dict(dt_init=0.001)])
    def test_both_reject_the_same_values(self, bad):
        with pytest.raises(jconfig.ConfigError):
            jconfig.PiecewiseICPConfig(**bad).validate()
        with pytest.raises(tconfig.ConfigError):
            tconfig.PiecewiseICPConfig(**bad).validate()


class TestPcd:
    @pytest.mark.parametrize("mode", ["ascii", "binary", "compressed"])
    def test_each_reads_what_the_other_wrote(self, rng, tmp_path, mode):
        pts = rng.normal(size=(777, 3)).astype(np.float32)
        kw = dict(binary=mode != "ascii", compressed=mode == "compressed")
        jio.write_pcd(tmp_path / "j.pcd", pts, **kw)
        tio.write_pcd(tmp_path / "t.pcd", pts, **kw)
        if mode != "compressed":
            # (the JAX package may compress through its native library:
            # another valid LZF stream of the same data)
            assert (tmp_path / "j.pcd").read_bytes() \
                == (tmp_path / "t.pcd").read_bytes()
        for reader in (jio.read_pcd, tio.read_pcd):
            for name in ("j.pcd", "t.pcd"):
                got = reader(tmp_path / name)
                assert got.dtype == np.float32
                if mode == "ascii":
                    np.testing.assert_allclose(got, pts, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(got, pts)
        np.testing.assert_array_equal(tio.read_pcd(tmp_path / "j.pcd"),
                                      jio.read_pcd(tmp_path / "t.pcd"))


class TestFormats:
    def test_writers_are_byte_equal(self, rng, tmp_path):
        mats = [np.eye(4) + 1e-3 * rng.normal(size=(4, 4)) for _ in range(3)]
        a = rng.normal(size=(6, 6))
        vcms = [1e-8 * (a @ a.T) for _ in range(3)]
        errors = np.abs(rng.normal(size=(3, 6)))
        pairs = {1: 0, 2: 0, 3: 1}
        out = {}
        for name, f in (("j", jio.formats), ("t", tio.formats)):
            d = tmp_path / name
            d.mkdir()
            f.write_trans_matrix_report(d / "TransMatrix.txt", mats[0],
                                        np.array([1e-3, -2e-3, 3e-3]),
                                        mats[0][:3, 3], vcms[0])
            f.write_trans_matrices(d / "TransMatrices.txt", [2, 3, 4], mats,
                                   vcms)
            (d / "TransParameters.txt").write_text(
                f.TRANS_PARA_HEADER + "\n" + "\n".join(
                    f.format_trans_para_row(k + 2, np.arange(6) * 1e-3, v)
                    for k, v in enumerate(vcms)) + "\n")
            f.write_reg_pairs(d / "RegPairFile.txt", pairs)
            f.write_abs_errors(d / "TransPara_AbsError.txt", errors)
            out[name] = {p.name: p.read_bytes() for p in d.iterdir()}
        assert out["j"].keys() == out["t"].keys() and len(out["t"]) == 5
        for name, want in out["j"].items():
            assert out["t"][name] == want, name

    def test_readers_agree(self, rng, tmp_path):
        mats = [np.eye(4) + 1e-3 * rng.normal(size=(4, 4)) for _ in range(2)]
        vcms = [1e-8 * np.eye(6), 2e-8 * np.eye(6)]
        jio.formats.write_trans_matrices(tmp_path / "m.txt", [2, 3], mats,
                                         vcms)
        jio.formats.write_trans_matrix_report(
            tmp_path / "r.txt", mats[0], np.zeros(3), np.zeros(3), vcms[0])
        jio.formats.write_reg_pairs(tmp_path / "p.txt", {1: 0, 2: 1})
        jio.formats.write_abs_errors(tmp_path / "e.txt", np.ones((2, 6)))
        (tmp_path / "g.txt").write_text(
            "".join(f"{k + 1}\n" + "\n".join(
                " ".join(f"{v:.9f}" for v in row) for row in m) + "\n"
                for k, m in enumerate(mats)))
        jt, jm, jv = jio.formats.read_trans_matrices(tmp_path / "m.txt", 2)
        tt, tm, tv = tio.formats.read_trans_matrices(tmp_path / "m.txt", 2)
        assert jt == tt
        np.testing.assert_array_equal(np.array(jm), np.array(tm))
        np.testing.assert_array_equal(np.array(jv), np.array(tv))
        jr = jio.formats.read_trans_matrix_report(tmp_path / "r.txt")
        tr = tio.formats.read_trans_matrix_report(tmp_path / "r.txt")
        assert jr.keys() == tr.keys()
        for k in jr:
            np.testing.assert_array_equal(jr[k], tr[k])
        assert jio.formats.read_reg_pairs(tmp_path / "p.txt") \
            == tio.formats.read_reg_pairs(tmp_path / "p.txt")
        np.testing.assert_array_equal(
            jio.formats.read_abs_errors(tmp_path / "e.txt"),
            tio.formats.read_abs_errors(tmp_path / "e.txt"))
        jgt, jg = jio.formats.read_ground_truth_transforms(tmp_path / "g.txt")
        tgt, tg = tio.formats.read_ground_truth_transforms(tmp_path / "g.txt")
        assert jgt == tgt == [1, 2]
        np.testing.assert_array_equal(np.array(jg), np.array(tg))


class TestFolders:
    def test_scan_epoch_folder_agrees(self, rng, tmp_path):
        scans = tmp_path / "scans"
        (scans / "deep").mkdir(parents=True)
        for k, sub in ((7, ""), (2, "deep"), (11, ""), (5, "")):
            tio.write_pcd(scans / sub / f"Epoch_{k:03d}.pcd",
                          rng.normal(size=(5, 3)).astype(np.float32))
        (scans / "notes.txt").write_text("not a scan")
        jf, jt = jio.scan_epoch_folder(scans)
        tf, tt = tio.scan_epoch_folder(scans)
        assert (tf, tt) == (jf, jt)
        assert tt == [2, 5, 7, 11]
        with pytest.raises(FileFormatError):
            tio.scan_epoch_folder(tmp_path / "missing")
        with pytest.raises(JFileFormatError):
            jio.scan_epoch_folder(tmp_path / "missing")
