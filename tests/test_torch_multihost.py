"""PyTorch port, a job of several hosts: the multi-controller join
(``initialize_worker`` at a rendezvous address, ``launch`` with a host
index, a host count and the address) and ``parallel.demo``, the
counterpart of ``eval/distributed_demo.py``.

The rank and card rules are held as pure functions with the CUDA device
count patched.  ONE spawn of 2 host launchers (processes of their own, as
``demo.run`` starts them) of 2 gloo ranks each registers the ``n_side=60``
pair of ``tests/test_parallel.py`` over a ``tcp://`` rendezvous (a
``file://`` one where the port was taken meanwhile): both launchers return
the same report, whose transform is bit-equal to a single-host launch of 4
ranks and within the mesh tolerances of the JAX package's
``piecewise_icp(mesh=make_mesh(4))`` on the conftest's virtual CPU
devices, given the patch sets the port's ranks build.  The demo's command
runs once more at that size and writes its report.  Each launch is
limited to 120 s; the ranks take one intra-op thread each.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from piecewise_icp_torch.ops.transform import matrix_to_angles
from piecewise_icp_torch.parallel import demo
from piecewise_icp_torch.parallel.distributed import (_init_method,
                                                      _rank_device,
                                                      check_backend, launch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARC_TO_MGON = 1000.0 * 200.0 / np.pi
# the pair of tests/test_parallel.py
PARAMS = np.array([0.001, -0.001, 0.0015, 0.003, -0.004, 0.002])
SPAWN_S = 120.0
HOSTS, NPROC = 2, 2


def _cards(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)


# --------------------------------------------------------------------------
# the rank and card rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("local,backend,device_type,count,want", [
    (0, "nccl", "cuda", 4, "cuda:0"), (3, "nccl", "cuda", 4, "cuda:3"),
    (1, "nccl", "cuda", 2, "cuda:1"),
    (3, "gloo", "cuda", 2, "cuda:1"), (1, "gloo", "cuda", 1, "cuda:0"),
    (5, "gloo", "cpu", 0, "cpu")])
def test_rank_device_follows_the_local_rank(monkeypatch, local, backend,
                                            device_type, count, want):
    """The local index chooses the card, whatever the global rank: under
    NCCL card i, under gloo i modulo the cards (ranks share them)."""
    _cards(monkeypatch, count)
    assert _rank_device(local, backend, device_type) == torch.device(want)


@pytest.mark.parametrize("local,backend,count", [
    (2, "nccl", 2), (4, "nccl", 4), (0, "gloo", 0)])
def test_rank_device_raises_without_its_card(monkeypatch, local, backend,
                                             count):
    """A rank that finds fewer cards than its local index needs raises."""
    _cards(monkeypatch, count)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _rank_device(local, backend, "cuda")


@pytest.mark.parametrize("nproc,device,backend,count,want", [
    (2, "cuda", None, 2, "nccl"), (4, "cuda", "nccl", 4, "nccl"),
    (4, "cuda", "gloo", 1, "gloo"), (3, "cpu", None, 0, "gloo"),
    (2, "cuda", "nccl", 1, "2 ranks on this host"),
    (4, "cuda", None, 2, "4 ranks on this host"),
    (1, "cuda", "gloo", 0, "no CUDA device")])
def test_check_backend_counts_this_hosts_ranks(monkeypatch, nproc, device,
                                               backend, count, want):
    """``nproc`` is this host's ranks, held against this host's cards: a
    host of 2 ranks on 2 cards runs NCCL in a job of any size; a host
    with fewer cards than ranks raises under NCCL (and never falls back to
    gloo)."""
    _cards(monkeypatch, count)
    if want in ("nccl", "gloo"):
        assert check_backend(nproc, device, backend) == want
    else:
        with pytest.raises(RuntimeError, match=want):
            check_backend(nproc, device, backend)


def test_rendezvous_addresses(tmp_path):
    assert _init_method("tcp://10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert _init_method("file:///shared/store") == "file:///shared/store"
    assert _init_method(str(tmp_path / "store")) == \
        "file://" + str(tmp_path / "store")


@pytest.mark.parametrize("kw,match", [
    (dict(host=2, hosts=2, address="tcp://127.0.0.1:1"), "host 2 of 2"),
    (dict(host=0, hosts=2), "address"),
    (dict(host=0, hosts=1, address="tcp://127.0.0.1:1"), "address")])
def test_launch_checks_its_host_before_any_rank(kw, match):
    """A host index out of range, several hosts without an address and
    one host with one (it keeps its own file store) raise at once."""
    with pytest.raises(ValueError, match=match):
        launch(demo.register_on_ranks, 2, device="cpu", timeout=SPAWN_S,
               **kw)


# --------------------------------------------------------------------------
# one job of 2 hosts x 2 gloo ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    from piecewise_icp_torch.config import PiecewiseICPConfig
    from piecewise_icp_torch.utils.synth import make_pair

    c1, c2, t_true = make_pair(np.random.default_rng(7), PARAMS, n_side=60)
    cfg = PiecewiseICPConfig(res1=0.022, res2=0.022, svsize1=0.22,
                             svsize2=0.22, dt_init=0.05, dt_min=0.004)
    return c1, c2, t_true, cfg


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread in every process the launches start (they
    inherit the environment)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def two_hosts(pair, one_thread, tmp_path_factory):
    """The demo's job: 2 host launchers x 2 gloo ranks on the CPU."""
    t0 = time.perf_counter()
    try:
        report = demo.run(*pair, hosts=HOSTS, nproc=NPROC, device="cpu",
                          timeout=SPAWN_S)
    except RuntimeError as e:
        if "address already in use" not in str(e).lower():
            raise
        store = tmp_path_factory.mktemp("rendezvous") / "store"
        report = demo.run(*pair, hosts=HOSTS, nproc=NPROC, device="cpu",
                          address="file://" + str(store), timeout=SPAWN_S)
    report["test_seconds"] = time.perf_counter() - t0
    return report


@pytest.fixture(scope="module")
def one_host(pair, one_thread):
    """The same rank function as ONE host's launch of 4 ranks."""
    c1, c2, _, cfg = pair
    return launch(demo.register_on_ranks, HOSTS * NPROC, c1, c2, cfg,
                  time.time(), device="cpu", timeout=SPAWN_S)


@pytest.fixture(scope="module")
def jax_mesh4(pair):
    """The JAX package's staged loop on a 4-device mesh, given the patch
    sets the port builds on the CPU (those of every rank)."""
    from piecewise_icp_tpu.config import PiecewiseICPConfig as JConfig
    from piecewise_icp_tpu.models.piecewise_icp import piecewise_icp
    from piecewise_icp_tpu.models.segmentation import PatchSet as JPatchSet
    from piecewise_icp_tpu.parallel.sharded import make_mesh

    from piecewise_icp_torch.models.segmentation import build_patches

    c1, c2, _, cfg = pair
    ps = [JPatchSet(**build_patches(c, cfg.svsize1, cfg, resolution=cfg.res1,
                                    device="cpu").to_numpy())
          for c in (c1, c2)]
    jcfg = JConfig(res1=cfg.res1, res2=cfg.res2, svsize1=cfg.svsize1,
                   svsize2=cfg.svsize2, dt_init=cfg.dt_init,
                   dt_min=cfg.dt_min)
    res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, jcfg, patches1=ps[0],
                        patches2=ps[1], mesh=make_mesh(4))
    return res.trans_mat


def test_both_launchers_return_the_same_report(two_hosts):
    """Each host launcher returns its local rank 0's result, and the
    gathered part of it (every rank's transform, device, start-up) is the
    same in both; every rank's transform has the same bits."""
    a, b = two_hosts["workers"]
    assert (a["process_id"], b["process_id"]) == (0, 1)
    for key in ("trans_mat", "params_gon_m", "iterations", "ranks",
                "mean_residual_mm", "process_count", "global_devices"):
        assert a[key] == b[key], key
    assert [r["rank"] for r in a["ranks"]] == list(range(HOSTS * NPROC))
    assert all(r["device"] == "cpu" for r in a["ranks"])
    assert two_hosts["ok"] and two_hosts["cross_process_param_diff"] == 0.0
    assert two_hosts["test_seconds"] < SPAWN_S


def test_two_hosts_bit_equal_to_one_host(two_hosts, one_host, pair):
    """2 hosts x 2 ranks give the bits of 1 host x 4 ranks, and meet the
    truth bound."""
    got = np.asarray(two_hosts["workers"][0]["trans_mat"])
    assert got.tobytes() == one_host["trans_mat"].tobytes()
    assert two_hosts["workers"][0]["iterations"] == one_host["iterations"]
    assert two_hosts["workers"][0]["mean_residual_mm"] < 2.0


def test_two_hosts_within_the_jax_mesh(two_hosts, jax_mesh4):
    """Within 0.5 mgon and 0.05 mm of the JAX package on 4 devices."""
    got = np.asarray(two_hosts["workers"][0]["trans_mat"])
    d_ang = (np.array(matrix_to_angles(got))
             - np.array(matrix_to_angles(jax_mesh4))) * ARC_TO_MGON
    d_mm = (got[:3, 3] - jax_mesh4[:3, 3]) * 1000
    assert np.abs(d_ang).max() < 0.5 and np.abs(d_mm).max() < 0.05


def test_demo_report_has_the_keys_of_the_jax_demo(two_hosts):
    """The report mirrors ``eval/distributed_report.json``."""
    with open(os.path.join(ROOT, "eval", "distributed_report.json")) as f:
        jax_report = json.load(f)
    assert set(jax_report) <= set(two_hosts)
    for w in two_hosts["workers"]:
        assert set(jax_report["workers"][0]) <= set(w)
        assert (w["process_count"], w["global_devices"],
                w["local_devices"]) == (HOSTS, HOSTS * NPROC, NPROC)


def test_demo_command_writes_its_report(one_thread, tmp_path, capsys):
    """``python -m piecewise_icp_torch.parallel.demo --device cpu``, as the
    README gives it, at a small size: exit 0, the report written and ok."""
    out = tmp_path / "distributed_report.json"
    assert demo.main(["--device", "cpu", "--n-side", "60", "--res", "0.022",
                      "--out", str(out)]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] and report["cross_process_param_diff"] == 0.0
    assert [w["process_id"] for w in report["workers"]] == [0, 1]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"]
