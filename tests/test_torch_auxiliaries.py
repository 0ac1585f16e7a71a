"""Parity of the port's auxiliaries against the JAX package: clustering
and metrics, the cluster estimators, the plots and progress bars, the
citation hooks, the version, the tomography bases helpers, the expparams
helpers and the package's exported names (``tests/test_plotting.py`` and
``tests/test_api_surface.py`` mirrored).

Tolerances. Clustering runs the same scikit-learn call on the same host
arrays in both packages, so labels are equal and distance matrices equal
at rtol 1e-12. The cluster moments come from the same float32 particles
summed in another order: atol 1e-6. The Hermitian helpers compare a
float32 eigensolver against another: eigenvalues at atol 1e-6, spectral
transforms at atol 2e-6 (a few float32 ulps of entries of size 1).
"""

import ast
import io
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu import tomography as jtomo
from qinfer_tpu.tomography import bases as jb

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import tomography as ttomo
from qinfer_tpu_torch.convert import state_from_numpy
from qinfer_tpu_torch.tomography import bases as tb

#: names of ``qinfer_tpu/__init__.py`` the port does not export (none: the
#: parallel names came last)
LATER = set()


def test_package_exports_every_name_of_the_jax_package():
    src = (Path(q.__file__).parent / "__init__.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    missing = sorted(n for n in names - LATER if not hasattr(qt, n))
    assert missing == []
    for n in names - LATER - {"ops"}:
        assert n in qt.__all__, n
    assert qt.__version__ == q.__version__ == qt.version


def test_auxiliaries_import_their_optional_packages_at_call_time():
    """scikit-learn and matplotlib are imported only by the calls that
    need them (the card's machine has neither)."""
    import subprocess
    import sys

    code = ("import sys, qinfer_tpu_torch, qinfer_tpu_torch.clustering, "
            "qinfer_tpu_torch.metrics, qinfer_tpu_torch.ipy, "
            "qinfer_tpu_torch.tomography.plotting_tools; "
            "print(sorted(m.split('.')[0] for m in sys.modules "
            "if m.split('.')[0] in ('sklearn', 'matplotlib', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(qt.__file__).parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _two_blobs(seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.05, (30, 2)),
                        rng.normal(4, 0.05, (30, 2)),
                        rng.uniform(-8, 12, (4, 2))]).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    return x, w / w.sum()


@pytest.mark.parametrize("weighted", [False, True])
def test_particle_clusters_match_jax(weighted):
    pytest.importorskip("sklearn")
    x, w = _two_blobs()
    kw = dict(eps=0.5, min_particles=3, weighted=weighted)
    want = {k: m for k, m in q.particle_clusters(x, w, **kw)}
    got = {k: m for k, m in qt.particle_clusters(torch.from_numpy(x),
                                                 torch.from_numpy(w), **kw)}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if not weighted:
        assert sum(1 for k in got if k != qt.NO_CLUSTER) == 2
    with pytest.raises(ValueError):
        list(qt.particle_clusters(x, None, weighted=True))


def test_rescaled_distance_matrix_matches_jax():
    from qinfer_tpu import metrics as jm
    from qinfer_tpu_torch import metrics as tm

    x, w = _two_blobs(1)
    for w_pow in (0.0, 0.5, 1.0):
        want = jm.rescaled_distance_mtx(w, x, w_pow=w_pow)
        got = tm.rescaled_distance_mtx(torch.from_numpy(w),
                                       torch.from_numpy(x), w_pow=w_pow)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(tm.weighted_pairwise_distances(
            w, x, w_pow=w_pow, metric="cityblock"),
            jm.weighted_pairwise_distances(w, x, w_pow=w_pow,
                                           metric="cityblock"), rtol=1e-12)


def _updaters_on(x, w):
    """A JAX and a port updater holding the cloud (x, w)."""
    d = x.shape[1]
    ju = q.SMCUpdater(q.MultiCosineModel(d), x.shape[0],
                      q.UniformDistribution([[0, 1]] * d), seed=0)
    ju.state = ju.state._replace(weights=jnp.asarray(w),
                                 locations=jnp.asarray(x))
    tu = qt.SMCUpdater(qt.MultiCosineModel(d), x.shape[0],
                       qt.UniformDistribution([[0, 1]] * d), seed=0,
                       device="cpu")
    arrays = {f: np.asarray(getattr(ju.state, f)) for f in ju.state._fields
              if f != "key"}
    tu.state = state_from_numpy(arrays, "cpu")
    return ju, tu


def test_cluster_estimators_match_jax():
    pytest.importorskip("sklearn")
    x, w = _two_blobs(2)
    ju, tu = _updaters_on(x, w)
    opts = {"eps": 0.5, "min_particles": 3}
    want = list(ju.est_cluster_moments(opts))
    got = list(tu.est_cluster_moments(opts))
    assert [g[0] for g in got] == [k[0] for k in want]
    for (_, ma, mua, ca), (_, mb, mub, cb) in zip(got, want):
        assert ma == pytest.approx(mb, abs=1e-6)
        np.testing.assert_allclose(mua, mub, atol=1e-6)
        np.testing.assert_allclose(ca, cb, atol=1e-6)
    covs = list(tu.est_cluster_covs(opts))
    assert [c[0] for c in covs] == [g[0] for g in got]
    metrics = tu.est_cluster_metrics(opts)
    jmetrics = ju.est_cluster_metrics(opts)
    assert metrics["n_clusters"] == jmetrics["n_clusters"] == 2
    assert metrics["n_noise"] == jmetrics["n_noise"]
    assert metrics["weight_in_clusters"] == pytest.approx(
        jmetrics["weight_in_clusters"], abs=1e-6)


def test_reprs_match_jax():
    x, w = _two_blobs(3)
    ju, tu = _updaters_on(x, np.full(64, 1 / 64, np.float32))
    assert repr(tu) == repr(ju)
    html = tu._repr_html_()
    assert html.startswith("<strong>SMCUpdater</strong> (64 particles")
    assert html.count("<tr>") == ju._repr_html_().count("<tr>") == 3


@pytest.fixture
def pyplot():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def test_plot_posterior_marginal_and_covariance(pyplot):
    model = qt.SimplePrecessionModel()
    u = qt.SMCUpdater(model, 500, qt.UniformDistribution([[0, 1]]), seed=0,
                      device="cpu")
    g = torch.Generator().manual_seed(1)
    for k in range(25):
        eps = {"t": torch.tensor([(9 / 8) ** k / 5])}
        u.update(model.simulate_experiment(g, torch.tensor([[0.6]]), eps),
                 eps)
    line = u.plot_posterior_marginal(smoothing=1.0)
    assert line is not None and len(line.get_xdata()) == 100
    r = qt.SMCUpdater(qt.RamseyModel(), 300,
                      qt.UniformDistribution([[0, 1], [0, 0.2]]), seed=0,
                      device="cpu")
    im = r.plot_covariance(corr=True, param_slice=[1, 0])
    assert im.get_array().shape == (2, 2)


def test_plot_rebit_posterior_and_coords_match_jax(pyplot):
    b = ttomo.pauli_basis(1)
    model = ttomo.TomographyModel(b)
    prior = ttomo.GinibreReditDistribution(b, rank=2)
    u = qt.SMCUpdater(model, 300, prior, seed=0, device="cpu")
    true_rho = np.array([[0.8, 0.25], [0.25, 0.2]], dtype=np.complex64)
    assert ttomo.plot_rebit_posterior(u, prior=prior,
                                      true_state=true_rho) is not None
    jmodel = jtomo.TomographyModel(jtomo.pauli_basis(1))
    pts = np.random.default_rng(0).uniform(-0.4, 0.4, (10, 3))
    np.testing.assert_allclose(
        ttomo.rebit_coords(model, torch.tensor(pts, dtype=torch.float32)),
        jtomo.rebit_coords(jmodel, jnp.asarray(pts, jnp.float32)),
        atol=1e-7)


def test_rb_decay_curves_plot(pyplot):
    rb = qt.RandomizedBenchmarkingModel()
    prior = qt.PostselectedDistribution(
        qt.UniformDistribution([[0.8, 1.0], [0.3, 0.6], [0.3, 0.6]]), rb)
    u = qt.SMCUpdater(rb, 300, prior, seed=0, device="cpu")
    ax = ttomo.plot_decaying_exponentials(
        u, true_modelparams=np.array([0.95, 0.5, 0.5]))
    assert len(ax.get_lines()) == 51


def test_progress_bars():
    from qinfer_tpu_torch.ipy import IPythonProgressBar, TextProgressBar

    out = io.StringIO()
    bar = TextProgressBar(stream=out)
    bar.start(10)
    for i in range(10):
        bar.update(i + 1)
    bar.finished()
    assert "10/10" in out.getvalue()
    nb = IPythonProgressBar()
    nb.start(5)
    nb.update(3)
    nb.finished()
    calls = []

    class Bar:
        def start(self, max):
            calls.append(("start", max))

        def update(self, n):
            calls.append(n)

        def finished(self):
            calls.append("done")

    qt.perf_test_multiple(2, qt.SimplePrecessionModel(), 50,
                          qt.UniformDistribution([[0, 1]]), 3,
                          progressbar=Bar, device="cpu")
    assert calls == [("start", 2), 1, 2, "done"]


def test_citation_hooks_are_inert():
    from qinfer_tpu_torch import _due

    @qt.due.dcite(qt.Doi("10.0/none"), description="x")
    def f(a):
        return a + 1

    assert f(1) == 2
    assert qt.BibTeX("@x{}") is None
    assert repr(_due.due) == repr(q.due)


def test_expparams_helpers_match_jax():
    arr = np.array([(1.5, 3), (2.5, 4)], dtype=[("t", "f4"), ("n_meas", "i4")])
    d = qt.expparams_to_dict(arr)
    assert set(d) == {"t", "n_meas"}
    back = qt.dict_to_expparams(d, [("t", "f4"), ("n_meas", "i4")])
    want = q.dict_to_expparams(q.expparams_to_dict(arr),
                               [("t", "f4"), ("n_meas", "i4")])
    np.testing.assert_array_equal(back, want)
    from qinfer_tpu.abstract_model import concat_expparams as jcat
    from qinfer_tpu_torch.abstract_model import concat_expparams

    got = concat_expparams([d, d])
    ref = jcat([q.expparams_to_dict(arr)] * 2)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    m, jmodel = qt.SimplePrecessionModel(), q.SimplePrecessionModel()
    assert m.allow_identical_outcomes is jmodel.allow_identical_outcomes
    assert m.clear_cache() is None and jmodel.clear_cache() is None


def test_identity_heuristic_and_dtypes():
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 64,
                      qt.UniformDistribution([[0, 1]]), seed=0, device="cpu")
    h = qt.IdentityHeuristic(u, {"t": torch.tensor([2.5])})
    assert float(h(0)["t"][0]) == 2.5
    np.testing.assert_allclose(qt.outer_product(torch.tensor([1.0, 2.0])),
                               [[1, 2], [2, 4]])
    from qinfer_tpu_torch import config

    assert qt.default_dtype == config.default_dtype == torch.float32
    assert qt.default_int_dtype == torch.int32
    qt.set_default_dtype(torch.float64)
    assert config.default_dtype == torch.float64
    qt.set_default_dtype(torch.float32)
    assert config.default_dtype == torch.float32
    with pytest.raises(qt.ResamplerError):
        raise qt.ResamplerError("synthetic")
    assert issubclass(qt.ResamplerError, RuntimeError)


def _hermitian(seed, n, d):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d, d)) + 1j * rng.normal(size=(n, d, d))
    return ((a + a.conj().transpose(0, 2, 1)) / 4).astype(np.complex64)


@pytest.mark.parametrize("d", [2, 4])
def test_hermitian_helpers_match_jax(d):
    rho = _hermitian(d, 7, d)
    np.testing.assert_array_equal(tb.embed_hermitian(rho).numpy(),
                                  np.asarray(jb.embed_hermitian(rho)))
    np.testing.assert_allclose(tb.hermitian_eigvalsh(rho).numpy(),
                               np.asarray(jb.hermitian_eigvalsh(rho)),
                               atol=1e-6)
    np.testing.assert_allclose(
        tb.hermitian_eigh_embedded(rho, lambda e: torch.clamp_min(e, 0.0)),
        np.asarray(jb.hermitian_eigh_embedded(
            jnp.asarray(rho), lambda e: jnp.clip(e, 0.0, None))), atol=2e-6)
    # the unembedding inverts the embedding
    np.testing.assert_allclose(
        tb.unembed_hermitian(tb.embed_hermitian(rho), d), rho, atol=0)


def test_covariance_to_superoperator_matches_jax():
    cov = np.random.default_rng(3).normal(size=(16, 16))
    cov = cov @ cov.T
    got = ttomo.pauli_basis(2).covariance_mtx_to_superop(torch.tensor(cov))
    want = jtomo.pauli_basis(2).covariance_mtx_to_superop(cov)
    assert got.shape == (4, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
