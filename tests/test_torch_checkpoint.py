"""Checkpoint and resume of the port (``qinfer_tpu_torch.checkpoint``)
against the JAX package's ``tests/test_checkpoint.py``.

Tolerances. A restored updater equals the saved one to the bit (weights,
locations, the evidence, the records), and a resumed run continues the
uninterrupted one to the bit on the CPU: the generators' states travel in
the archive, and the same process runs the same operations on the same
shapes. The archive carries the JAX package's array names, less its state
key (the port's random stream is a generator, saved beside it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu import checkpoint as jck

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import checkpoint as ck


def _eps(t):
    return {"t": torch.tensor([t], dtype=torch.float32)}


def _run_updater(seed=0, n=800, steps=15):
    model = qt.SimplePrecessionModel()
    u = qt.SMCUpdater(model, n, qt.UniformDistribution([[0.0, 1.0]]),
                      seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 50)
    for k in range(steps):
        eps = _eps((9 / 8) ** k / 5)
        u.update(model.simulate_experiment(g, torch.tensor([[0.5]]), eps),
                 eps)
    return u


def _fresh(n=800, seed=99):
    return qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                         qt.UniformDistribution([[0, 1]]), seed=seed,
                         device="cpu")


def _same(a, b):
    """Two updaters in the same state, to the bit."""
    assert torch.equal(a.particle_weights, b.particle_weights)
    assert torch.equal(a.particle_locations, b.particle_locations)
    assert a.resample_count == b.resample_count
    assert a.log_total_likelihood == b.log_total_likelihood
    assert a._n_record == b._n_record
    assert a._mcmc_log_scale == b._mcmc_log_scale
    assert a._mcmc_adapt_t == b._mcmc_adapt_t


def test_npz_roundtrip(tmp_path):
    u = _run_updater()
    path = tmp_path / "ckpt.npz"
    qt.save_updater(path, u)
    u2 = _fresh()
    qt.load_updater(path, u2)
    _same(u, u2)
    assert len(u2.data_record) == len(u.data_record)
    assert u2.normalization_record == u.normalization_record
    assert u2.min_n_ess == u.min_n_ess


def test_resume_continues_identically(tmp_path):
    """Saving, restoring into an updater of another seed, then updating
    equals never having saved, to the bit (JAX holds est_mean at 1e-7)."""
    u = _run_updater(seed=3)
    path = tmp_path / "c.npz"
    qt.save_updater(path, u)
    u2 = _fresh(seed=1)
    qt.load_updater(path, u2)
    for k in range(6):
        eps = _eps(2.0 + k)
        u.update(k % 2, eps)
        u2.update(k % 2, eps)
        _same(u, u2)


def test_archive_names_are_the_jax_packages(tmp_path):
    """The same rejuvenating configuration saved by both packages gives
    the same array names, less JAX's state key and the port's generator
    states."""
    jm = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=12)
    tm = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=12)
    ju = q.SMCUpdater(jm, 64, q.UniformDistribution([[0, 1]]),
                      n_mcmc_moves=1, compress_mcmc_record=True,
                      mcmc_adapt=True, zero_weight_policy="reset")
    tu = qt.SMCUpdater(tm, 64, qt.UniformDistribution([[0, 1]]),
                       n_mcmc_moves=1, compress_mcmc_record=True,
                       mcmc_adapt=True, zero_weight_policy="reset",
                       device="cpu")
    ju.update(3, {"t": jnp.array([1.0]), "n_meas": jnp.array([12])})
    tu.update(3, {"t": torch.tensor([1.0]),
                  "n_meas": torch.tensor([12], dtype=torch.int32)})
    q.save_updater(str(tmp_path / "j"), ju)
    qt.save_updater(str(tmp_path / "t"), tu)
    jn = set(np.load(str(tmp_path / "j.npz")).files) - {"key"}
    tn = set(np.load(str(tmp_path / "t.npz")).files)
    assert tn - jn == {"__generator_state", "__generator_device"}
    assert jn <= tn


def test_checkpoint_vector_outcomes_roundtrip(tmp_path):
    m = qt.MultinomialModel(qt.NDieModel(3), n_meas_max=10)
    u = qt.SMCUpdater(m, 200, qt.MVUniformDistribution(3), seed=0,
                      device="cpu")
    eps = {"exp_num": torch.tensor([0], dtype=torch.int32),
           "n_meas": torch.tensor([10], dtype=torch.int32)}
    u.update(torch.tensor([5, 3, 2]), eps, check_for_resample=False)
    u.update(torch.tensor([4, 4, 2]), eps, check_for_resample=False)
    path = tmp_path / "vec_ckpt.npz"
    qt.save_updater(path, u)
    u2 = qt.SMCUpdater(m, 200, qt.MVUniformDistribution(3), seed=1,
                       device="cpu")
    qt.load_updater(path, u2)
    np.testing.assert_array_equal(np.asarray(u2.data_record),
                                  [[5, 3, 2], [4, 4, 2]])
    _same(u, u2)


def test_checkpoint_extensionless_path_roundtrip(tmp_path):
    u = _run_updater(n=200, steps=5)
    path = str(tmp_path / "noext")
    qt.save_updater(path, u)
    u2 = _fresh(n=200, seed=5)
    qt.load_updater(path, u2)
    _same(u, u2)


def test_checkpoint_restores_n_particles(tmp_path):
    u = _run_updater(n=800, steps=5)
    path = tmp_path / "big.npz"
    qt.save_updater(path, u)
    u2 = _fresh(n=100, seed=5)
    qt.load_updater(path, u2)
    assert u2.n_particles == 800
    u2.update(1, _eps(1.0))


def test_state_arrays_roundtrip():
    u = _run_updater(n=100, steps=4)
    arrays = ck.state_to_arrays(u.state)
    st = ck.arrays_to_state(arrays, device="cpu")
    for f in ("weights", "locations", "log_total_likelihood", "min_n_ess",
              "resampler_fallback_count"):
        assert torch.equal(getattr(st, f), getattr(u.state, f)), f
    assert (st.resample_count, st.just_resampled, st.zero_weight_count) == (
        u.state.resample_count, u.state.just_resampled,
        u.state.zero_weight_count)


@pytest.mark.parametrize("compress, adapt", [(True, False), (False, False),
                                             (True, True)])
def test_resume_carries_the_rejuvenation_record(tmp_path, compress, adapt):
    """The rejuvenation record (compressed pool or full record) and the
    Robbins-Monro state travel: a run interrupted at step 12, saved and
    restored into a fresh updater, continues the uninterrupted one to the
    bit (JAX: mean at 1e-6)."""
    model = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=12)
    prior = qt.UniformDistribution([[0.0, 1.0]])
    pool_t = np.asarray([0.5, 1.7, 3.1, 6.4], np.float32)
    ts = pool_t[np.random.default_rng(5).integers(0, 4, 24)]
    outs = np.random.default_rng(6).integers(0, 13, 24)

    def make(seed=7):
        return qt.SMCUpdater(model, 512, prior, seed=seed, n_mcmc_moves=3,
                             compress_mcmc_record=compress,
                             mcmc_adapt=adapt, zero_weight_policy="reset",
                             device="cpu")

    def step(u, i):
        u.update(int(outs[i]), {
            "t": torch.tensor(ts[i:i + 1]),
            "n_meas": torch.tensor([12], dtype=torch.int32)})

    ref = make()
    for i in range(24):
        step(ref, i)
    u = make()
    for i in range(12):
        step(u, i)
    path = str(tmp_path / "ck")
    qt.save_updater(path, u)
    v = make(seed=8)
    qt.load_updater(path, v)
    if compress:
        assert len(v._pool_eps) == len(u._pool_eps) > 0
        assert v._pool_index.keys() == u._pool_index.keys()
        assert v._pool_trials == u._pool_trials
        assert v._n_record == 12
    else:
        assert len(v._eps_record) == 12
    _same(u, v)
    for i in range(12, 24):
        step(v, i)
    _same(ref, v)
    assert ref.resample_count > 1


def test_design_generator_travels(tmp_path):
    """A keyed likelihood's design stream is saved and restored: after a
    scoring call advanced it, the restored updater scores candidates as
    the saved one does."""
    model = qt.PoisonedModel(qt.SimplePrecessionModel(), tol=0.05)
    prior = qt.UniformDistribution([[0, 1]])
    u = qt.SMCUpdater(model, 300, prior, seed=2, device="cpu")
    u.update(0, _eps(1.0))
    cand = {"t": torch.linspace(0.5, 5.0, 6)}
    u.expected_information_gain(cand)
    qt.save_updater(tmp_path / "d.npz", u)
    v = qt.SMCUpdater(model, 300, prior, seed=9, device="cpu")
    qt.load_updater(tmp_path / "d.npz", v)
    assert torch.equal(v._design_generator.get_state(),
                       u._design_generator.get_state())
    assert torch.equal(u.expected_information_gain(cand),
                       v.expected_information_gain(cand))
    u.update(1, _eps(2.0))
    v.update(1, _eps(2.0))
    _same(u, v)


def _drop(path, out, key):
    arrays = dict(np.load(path))
    del arrays[key]
    np.savez(out, **arrays)


@pytest.mark.parametrize("missing", ["__mcmc_log_scale", "__mcmc_adapt_t"])
def test_truncated_adaptive_archive_is_refused_by_name(tmp_path, missing):
    """An archive flagged adaptive that lacks half of its Robbins-Monro
    state: the JAX package's restore checks only the log scale and so
    raises TypeError on a missing adaptation count; the port raises
    ValueError naming the missing key."""
    tm = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=8)

    def tmake():
        return qt.SMCUpdater(tm, 64, qt.UniformDistribution([[0, 1]]),
                             n_mcmc_moves=1, compress_mcmc_record=True,
                             mcmc_adapt=True, zero_weight_policy="reset",
                             device="cpu")

    u = tmake()
    u.update(2, {"t": torch.tensor([1.0]),
                 "n_meas": torch.tensor([8], dtype=torch.int32)})
    qt.save_updater(tmp_path / "full.npz", u)
    _drop(tmp_path / "full.npz", tmp_path / "cut.npz", missing)
    with pytest.raises(ValueError, match=missing):
        qt.load_updater(tmp_path / "cut.npz", tmake())
    if missing == "__mcmc_adapt_t":
        jm = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=8)

        def jmake():
            return q.SMCUpdater(jm, 64, q.UniformDistribution([[0, 1]]),
                                n_mcmc_moves=1, compress_mcmc_record=True,
                                mcmc_adapt=True, zero_weight_policy="reset")

        ju = jmake()
        ju.update(2, {"t": jnp.array([1.0]), "n_meas": jnp.array([8])})
        jck.save_updater(tmp_path / "jfull.npz", ju)
        _drop(tmp_path / "jfull.npz", tmp_path / "jcut.npz", missing)
        with pytest.raises(TypeError):
            jck.load_updater(tmp_path / "jcut.npz", jmake())


def test_generator_of_another_device_type_is_refused(tmp_path):
    u = _run_updater(n=100, steps=3)
    qt.save_updater(tmp_path / "g.npz", u)
    arrays = dict(np.load(tmp_path / "g.npz"))
    arrays["__generator_device"] = np.asarray("cuda")
    np.savez(tmp_path / "g_cuda.npz", **arrays)
    with pytest.raises(ValueError, match="cuda generator"):
        qt.load_updater(tmp_path / "g_cuda.npz", _fresh(n=100))
