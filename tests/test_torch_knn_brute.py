"""PyTorch port, the brute k-NN (K6) held on the CPU: ``knn_brute_plain``
against the JAX package's ``ops/nn.py:knn`` and a numpy sort, the SOR-mean
epilogue against the JAX package's distinct-value min extraction (copied
here as the oracle) bit for bit and against ``native.sor_mean_dist``, and
the callers that go through it.  The kernel itself is held against the
plain version on the card by ``tests/test_torch_kernels.py`` (``cuda``).

Distance tolerance against JAX: 2 ulp (XLA on the CPU contracts the squared
distance into fused multiply-adds; the port rounds every product and sum
separately, as its kernels do).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu import native
from piecewise_icp_tpu.ops.nn import knn as jknn

from piecewise_icp_torch.ops import _cuda, nn_cuda
from piecewise_icp_torch.ops import preprocess as tpre
from piecewise_icp_torch.ops.nn_cuda import _chunk_rows, sqdist

from util import terrain_cloud

ULP = 2


def _lattice(n=(16, 16, 6), step=0.05):
    """Points on a regular lattice: every query meets many exact ties."""
    g = np.stack(np.meshgrid(*(np.arange(m) for m in n), indexing="ij"),
                 -1).reshape(-1, 3)
    return (step * g).astype(np.float32)


def _sparse_cloud(rng, n_side, n_sparse):
    """A terrain scan with ``n_sparse`` isolated points above it, thinning
    out with height (``tests/test_torch_prep.py``'s)."""
    pts = terrain_cloud(rng, n_side=n_side)
    z0 = float(pts[:, 2].max()) + 0.2
    sparse = np.stack([rng.uniform(0.0, 2.0, n_sparse),
                       rng.uniform(0.0, 2.0, n_sparse),
                       z0 + rng.exponential(1.0, n_sparse)], axis=1)
    return np.concatenate([pts, sparse.astype(np.float32)])


def _numpy_knn_d2(q, t, k, t_mask=None):
    """The k smallest squared distances by a full numpy sort, rounded as
    the port rounds them."""
    d = q[:, None, :] - t[None, :, :]
    with np.errstate(over="ignore"):             # sentinel targets
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
    ok = d2 < np.float32(1e30)
    if t_mask is not None:
        ok &= t_mask[None, :]
    d2 = np.sort(np.where(ok, d2, np.float32(np.inf)), axis=1)[:, :k]
    if d2.shape[1] < k:
        d2 = np.pad(d2, ((0, 0), (0, k - d2.shape[1])),
                    constant_values=np.inf)
    return d2.astype(np.float32)


def _old_exact_knn_means(queries, targets, k):
    """The oracle: the SOR rescue as the JAX package writes it
    (``piecewise_icp_tpu/ops/preprocess.py``, ``chunk_means``) and the
    port computed it before K6: k + 1 rounds of distinct-value min
    extraction, ties advancing the rank by their count."""
    rows = _chunk_rows(targets.shape[0], targets.device)
    out = []
    for s in range(0, queries.shape[0], rows):
        d2 = sqdist(queries[s:s + rows, None, :], targets[None, :, :])
        nq = d2.shape[0]
        big = torch.tensor(1e30, dtype=d2.dtype)
        acc = torch.zeros(nq, dtype=d2.dtype)
        rank = torch.zeros_like(acc)
        cur = torch.full_like(acc, -1.0)
        budget = float(k + 1)
        for _ in range(k + 1):
            nxt = torch.where(d2 > cur[:, None], d2, big).min(dim=1).values
            cnt = (d2 == nxt[:, None]).sum(dim=1).to(d2.dtype)
            take = torch.minimum(torch.clamp(budget - rank, min=0.0), cnt)
            valid = nxt < big
            acc = acc + torch.where(
                valid, take * torch.sqrt(torch.clamp(nxt, min=0.0)), 0.0)
            rank = rank + torch.where(valid, take, 0.0)
            cur = torch.where(valid, nxt, cur)
        out.append(acc / torch.clamp(rank - 1.0, min=1.0))
    return torch.cat(out)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("k", [1, 2, 15, 16, 32])
@pytest.mark.parametrize("case", ["lattice", "masked", "few_targets"])
def test_plain_matches_jax_knn_and_a_sort(k, case):
    """The K squared distances with multiplicity equal a numpy sort bit for
    bit, and their square roots JAX's ``knn`` distances within 2 ulp: on a
    lattice of exact ties with duplicated points, with masked targets and
    some at the 1e30 sentinel, and with fewer valid targets than K."""
    rng = np.random.default_rng(k)
    t = _lattice()
    t[-30:] = t[:30]                                  # exact duplicates
    q = t[rng.choice(len(t), 300, replace=False)].copy()
    q[::2] += rng.normal(scale=0.01, size=q[::2].shape).astype(np.float32)
    tm = None
    if case == "masked":
        tm = rng.uniform(size=len(t)) > 0.2
        t[rng.choice(len(t) - 30, 40, replace=False)] = 1e30
    elif case == "few_targets":
        t, tm = t[:40].copy(), np.arange(40) % 4 == 0   # 10 valid
    tt, qq = torch.from_numpy(t), torch.from_numpy(q)
    mm = None if tm is None else torch.from_numpy(tm)
    d2 = nn_cuda.knn_brute_plain(qq, tt, k, mm)
    np.testing.assert_array_equal(d2.numpy(), _numpy_knn_d2(q, t, k, tm))
    d = nn_cuda.knn_brute_plain(qq, tt, k, mm, "dist")
    assert _same_bits(d, torch.sqrt(d2))
    jm = jnp.ones(len(t), bool) if tm is None else jnp.asarray(tm)
    # JAX's knn keeps a sentinel target as a neighbour: hand it the mask
    jm = jm & jnp.asarray(t[:, 0] < 1e29)
    _, jd = jknn(jnp.asarray(q), jnp.asarray(t), k, t_mask=jm)
    jd = np.asarray(jd)
    finite = np.isfinite(jd)
    assert np.array_equal(finite, np.isfinite(d.numpy()))
    np.testing.assert_array_max_ulp(d.numpy()[finite], jd[finite],
                                    maxulp=ULP)
    if case == "few_targets":
        assert np.isinf(d.numpy()[:, 10:]).all()


@pytest.mark.parametrize("k", [1, 6, 14, 15, 31])
def test_sor_means_equal_the_old_formula_on_a_lattice(k):
    """The SOR-mean epilogue gives the bits of the distinct-value min
    extraction, with runs of exact ties cut by the budget of k + 1, with
    masked-out (sentinel) targets, and with fewer targets than k + 1."""
    t = _lattice()
    t[-30:] = t[:30]
    q = torch.from_numpy(t[::5].copy())
    for targets in (t, np.where(np.arange(len(t))[:, None] % 7 == 0,
                                np.float32(1e30), t), t[:9]):
        tt = torch.from_numpy(np.ascontiguousarray(targets))
        want = _old_exact_knn_means(q, tt, k)
        got = tpre._exact_knn_means(q, tt, k)
        assert _same_bits(got, want)


def test_sor_means_equal_the_old_formula_and_native_on_a_sparse_cloud():
    """On the staged SOR's kind of cloud (terrain with isolated points
    above it, voxelised): the rescue's statistic equals the old formula bit
    for bit and the JAX package's native ``sor_mean_dist`` (float64) within
    1e-6 relative."""
    rng = np.random.default_rng(4)
    cloud = _sparse_cloud(rng, 64, 1500)
    down = tpre.voxel_downsample(cloud, 0.02)
    # every isolated point above the surface, and a fifth of the rest
    above = down[:, 2] > cloud[:-1500, 2].max()
    sel = np.flatnonzero(above | (np.arange(len(down)) % 5 == 0))
    assert above.sum() > 1000
    q, t = torch.from_numpy(down[sel]), torch.from_numpy(down)
    k = 14
    got = tpre._exact_knn_means(q, t, k)
    assert _same_bits(got, _old_exact_knn_means(q, t, k))
    want = native.sor_mean_dist(down, k)[sel].astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_knn_brute_checks_k_and_the_epilogue():
    """1 <= k <= 32 on every device (the kernel's lists), and only the
    three epilogues."""
    t = torch.from_numpy(_lattice((4, 4, 4)))
    for k in (0, 33):
        with pytest.raises(ValueError):
            nn_cuda.knn_brute(t, t, k)
    with pytest.raises(ValueError):
        nn_cuda.knn_brute(t, t, 4, epilogue="sum")
    assert nn_cuda.knn_brute(t, t, 32).shape == (64, 32)
    assert nn_cuda.knn_brute(t[:0], t, 3, epilogue="sor_mean").shape == (0,)


def test_callers_go_through_knn_brute(monkeypatch):
    """``knn_distances`` (the brute SOR, resolution estimation) and the
    staged SOR's rescue reach K6's wrapper, which on CPU tensors runs the
    plain version and counts nothing."""
    calls = []
    real = nn_cuda.knn_brute

    def counting(q, t, k, t_mask=None, epilogue="d2"):
        calls.append((k, epilogue))
        return real(q, t, k, t_mask, epilogue)

    monkeypatch.setattr(nn_cuda, "knn_brute", counting)
    monkeypatch.setattr(tpre, "knn_brute", counting)
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(terrain_cloud(rng, n_side=30))
    _cuda.reset_counts()
    tpre.sor_filter_mask(pts, None, 14, 2.7)
    tpre.estimate_resolution(pts)
    tpre._exact_knn_means(pts[:50].contiguous(), pts, 14)
    assert calls == [(15, "dist"), (2, "dist"), (15, "sor_mean")]
    assert not _cuda.LAUNCHES and not _cuda.PLAIN_ON_CUDA
