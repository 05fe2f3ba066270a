"""The frozen generators give the bytes of the program's own at a small
size and the same seed."""

import numpy as np

from benchmark.generators import rockfall, synth


def test_synth_same_bytes():
    from piecewise_icp_torch.utils import synth as program

    seed = 2**31 + 11
    a, ga = program.make_series(np.random.default_rng(seed), 3, n_side=40,
                                trend=(0.0, 0.0, 0.02))
    b, gb = synth.make(np.random.default_rng(seed), 3, n_side=40,
                       trend=(0.0, 0.0, 0.02))
    assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert all(np.array_equal(x, y) for x, y in zip(ga, gb))


def test_rockfall_same_bytes(tmp_path):
    from piecewise_icp_torch.io import read_pcd
    from piecewise_icp_torch.utils import rockfall as program

    scans = program.generate_rockfall(str(tmp_path), n_epochs=2, seed=5,
                                      extent=(20.0, 15.0), res=0.8)
    files = sorted(p for p in tmp_path.joinpath("scans").iterdir())
    eps, gt = rockfall.make(np.random.default_rng(5), 2, extent=(20.0, 15.0),
                            res=0.8)
    assert len(files) == 2 and scans
    for f, e in zip(files, eps):
        assert read_pcd(f).tobytes() == e.tobytes()


def test_same_seed_same_inputs():
    a, _ = synth.make(np.random.default_rng(7), 2, n_side=20)
    b, _ = synth.make(np.random.default_rng(7), 2, n_side=20)
    c, _ = synth.make(np.random.default_rng(8), 2, n_side=20)
    assert a[1].tobytes() == b[1].tobytes() != c[1].tobytes()


def test_rockfall_scene_seed_fixes_the_face():
    """With ``scene_seed`` the face is the scene seed's; the run's seed
    draws the scanner's motion, raster and noise."""
    kw = dict(extent=(20.0, 15.0), res=0.8, scene_seed=7)
    a, ga = rockfall.make(np.random.default_rng(1), 2, **kw)
    b, gb = rockfall.make(np.random.default_rng(1), 2, **kw)
    c, gc = rockfall.make(np.random.default_rng(2), 2, **kw)
    assert a[1].tobytes() == b[1].tobytes() != c[1].tobytes()
    assert not np.array_equal(ga[1], gc[1])
