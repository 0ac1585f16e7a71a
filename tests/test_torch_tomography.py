"""Parity of the port's tomography slice (bases, models, distributions,
heuristics) against the JAX package on the same NumPy inputs.

Tolerances:

* the embedded basis, the process model's effect tensor, the heuristics'
  coordinate tables: equal to the last bit (the same host NumPy code);
* embedded states and likelihoods: 2e-6 absolute (float32 matrix
  products summed in another order);
* validity masks: equal, except rows whose smallest eigenvalue lies
  within 1e-5 of the ``-psd_tol`` boundary (XLA's unrolled Cholesky
  against LAPACK's);
* ``canonicalize``: rows inside the strict cone come back bit-identical
  in both packages; projected rows agree to 3e-5 in coordinates (the
  JAX package projects with 6 Jacobi sweeps at d ≤ 16 and with
  ``jnp.linalg.eigh`` at d = 32, the port with 8 sweeps; both are within
  ~1e-5 of float64);
* samples: the mean purity within 0.01 of the JAX package's (5000
  samples each: the standard error of either mean is under 0.002);
* diffusion: the step's mean within 4e-4 of 0 and its standard deviation
  within 3 % of ``rate·√t`` (1.5e5 coordinate steps), as in JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu.tomography as jtomo
from qinfer_tpu.smc import SMCUpdater as JaxSMCUpdater

import qinfer_tpu_torch as qt
import qinfer_tpu_torch.tomography as ttomo
from qinfer_tpu_torch.convert import tomography_basis_from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small ops; with several test
    workers on one machine, torch's default of one thread per core
    oversubscribes the cores many times over. One thread keeps them fast."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BASES = {
    "pauli1": lambda m: m.pauli_basis(1),
    "pauli2": lambda m: m.pauli_basis(2),
    "pauli3": lambda m: m.pauli_basis(3),
    "gell_mann3": lambda m: m.gell_mann_basis(3),
    "pauli1_x_gell_mann3": lambda m: m.tensor_product_basis(
        m.pauli_basis(1), m.gell_mann_basis(3)),
}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _min_eig(basis, mps):
    """Smallest eigenvalue (float64) of each state with traceless
    coordinates ``mps``."""
    d = basis.dim
    coords = np.concatenate(
        [np.full((mps.shape[0], 1), 1 / np.sqrt(d)), mps], axis=1)
    rho = np.einsum("ni,iab->nab", coords,
                    np.asarray(basis.data, np.complex128))
    return np.linalg.eigvalsh(rho)[:, 0]


@pytest.mark.parametrize("name", sorted(_BASES))
def test_bases_match_jax_to_the_bit(name):
    jb, tb = _BASES[name](jtomo), _BASES[name](ttomo)
    np.testing.assert_array_equal(tb.data, np.asarray(jb.data))
    assert tb.dims == jb.dims and tb.labels == jb.labels
    want = np.asarray(jb.data_embedded)
    assert np.array_equal(tb.data_embedded.numpy(), want)
    cb = tomography_basis_from_numpy(np.asarray(jb.data), jb.dims,
                                     jb.labels)
    assert np.array_equal(cb.data_embedded.numpy(), want)
    assert cb.labels == jb.labels and cb.dim == jb.dim


@pytest.mark.parametrize("nq", [1, 2])
def test_effect_tensor_matches_jax_to_the_bit(nq):
    jm = jtomo.ProcessTomographyModel(jtomo.pauli_basis(2 * nq),
                                      jtomo.pauli_basis(nq))
    tm = ttomo.ProcessTomographyModel(ttomo.pauli_basis(2 * nq),
                                      ttomo.pauli_basis(nq))
    assert np.array_equal(tm.effect_tensor.numpy(),
                          np.asarray(jm.effect_tensor))
    assert tm.expparams_dtype == jm.expparams_dtype


def test_coordinates_and_embedding_match_jax():
    jb, tb = jtomo.pauli_basis(2), ttomo.pauli_basis(2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    m_j = np.asarray(jb.coords_to_embedded(jnp.asarray(x)))
    m_t = tb.coords_to_embedded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        tb.embedded_to_coords(torch.tensor(m_j)).numpy(),
        np.asarray(jb.embedded_to_coords(jnp.asarray(m_j))), atol=2e-6)
    rho = tb.modelparams_to_state(x)
    np.testing.assert_allclose(rho, np.asarray(jb.modelparams_to_state(x)),
                               atol=1e-6)
    np.testing.assert_allclose(tb.state_to_modelparams(rho).numpy(), x,
                               atol=2e-6)


def _models(kind):
    """(jax model, port model, jax prior, port prior, n_rvs) for one
    configuration of the slice."""
    if kind == "state1":
        return (jtomo.TomographyModel(jtomo.pauli_basis(1)),
                ttomo.TomographyModel(ttomo.pauli_basis(1)),
                jtomo.GinibreDistribution(jtomo.pauli_basis(1)),
                ttomo.GinibreDistribution(ttomo.pauli_basis(1)))
    if kind == "state2":
        return (jtomo.TomographyModel(jtomo.pauli_basis(2)),
                ttomo.TomographyModel(ttomo.pauli_basis(2)),
                jtomo.GinibreDistribution(jtomo.pauli_basis(2)),
                ttomo.GinibreDistribution(ttomo.pauli_basis(2)))
    if kind == "state3":
        return (jtomo.TomographyModel(jtomo.pauli_basis(3)),
                ttomo.TomographyModel(ttomo.pauli_basis(3)),
                jtomo.GinibreDistribution(jtomo.pauli_basis(3)),
                ttomo.GinibreDistribution(ttomo.pauli_basis(3)))
    nq = 1 if kind == "process1" else 2
    return (jtomo.ProcessTomographyModel(jtomo.pauli_basis(2 * nq),
                                         jtomo.pauli_basis(nq)),
            ttomo.ProcessTomographyModel(ttomo.pauli_basis(2 * nq),
                                         ttomo.pauli_basis(nq)),
            jtomo.BCSZChoiDistribution(jtomo.pauli_basis(2 * nq)),
            ttomo.BCSZChoiDistribution(ttomo.pauli_basis(2 * nq)))


#: embedded d of each configuration: 4, 8, 16, 8, 32
_KINDS = ["state1", "state2", "state3", "process1", "process2"]


def _pushed(kind, n=120, seed=0):
    """Prior samples (from the JAX package) with every other row pushed
    out of the cone by scaling its traceless coordinates by 1.6."""
    jm, _, jp, _ = _models(kind)
    mp = np.asarray(jp.sample(jax.random.key(seed), n))
    mp = np.where((np.arange(n) % 2 == 0)[:, None], 1.6 * mp, mp)
    return mp.astype(np.float32)


@pytest.mark.parametrize("kind", ["state2", "process1", "process2"])
def test_likelihood_matches_jax(kind):
    jm, tm, _, _ = _models(kind)
    mp = _pushed(kind, 64)
    rng = np.random.default_rng(1)
    if kind.startswith("process"):
        n_sys = tm.system_basis.n_ops
        eps = {"prep": rng.normal(size=(3, n_sys)).astype(np.float32) / 4,
               "meas": rng.normal(size=(3, n_sys)).astype(np.float32) / 4}
        # unit-trace system operators: first coordinate 1/√d
        eps["prep"][:, 0] = eps["meas"][:, 0] = 1 / np.sqrt(tm.hilbert_dim)
    else:
        eps = {"meas": rng.normal(size=(3, tm.basis.n_ops))
               .astype(np.float32) / 4}
    outcomes = np.array([0, 1], np.int32)
    want = np.asarray(jm.likelihood(
        jnp.asarray(outcomes), jnp.asarray(mp),
        {k: jnp.asarray(v) for k, v in eps.items()}))
    got = tm.likelihood(torch.from_numpy(outcomes), torch.from_numpy(mp),
                        {k: torch.from_numpy(v) for k, v in eps.items()})
    assert got.shape == want.shape == (2, 64, 3)
    assert 0.0 < want[0].mean() < 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("kind", _KINDS)
def test_are_models_valid_matches_jax(kind):
    jm, tm, _, _ = _models(kind)
    mp = _pushed(kind)
    want = np.asarray(jm.are_models_valid(jnp.asarray(mp)))
    got = tm.are_models_valid(torch.from_numpy(mp)).numpy()
    near = np.abs(_min_eig(tm.basis, mp) + tm.psd_tol) < 1e-5
    np.testing.assert_array_equal(got[~near], want[~near])
    assert got.any() and (~got).any()


@pytest.mark.parametrize("kind", _KINDS)
def test_canonicalize_matches_jax(kind):
    jm, tm, _, _ = _models(kind)
    mp = _pushed(kind, seed=3)
    want = np.asarray(jm.canonicalize(jnp.asarray(mp)))
    tm.projection_count = 0
    got = tm.canonicalize(torch.from_numpy(mp)).numpy()
    untouched = np.all(want == mp, axis=1) & np.all(got == mp, axis=1)
    inside = _min_eig(tm.basis, mp) > 1e-4
    # strictly valid rows pass through both packages bit for bit
    assert np.array_equal(untouched[inside], np.ones(inside.sum(), bool))
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert bool(tm.are_models_valid(torch.from_numpy(got)).all())
    assert tm.projection_count == (0 if tm.dim == 2 else 1)
    # a batch already inside the strict cone runs no projection
    tm.projection_count = 0
    ok = torch.from_numpy(mp[inside])
    assert torch.equal(tm.canonicalize(ok), ok)
    assert tm.projection_count == 0


def test_canonicalize_routes_by_embedded_dimension():
    """K4 (its plain version here) up to embedded d = 16, K5 to d = 32,
    ``torch.linalg.eigh`` beyond: every route is the same projection,
    within 3e-6 of float64."""
    rng = np.random.default_rng(2)
    for d in (8, 16, 32, 34):
        k = d // 2
        g = rng.normal(size=(12, k, k)) + 1j * rng.normal(size=(12, k, k))
        rho = g @ g.conj().transpose(0, 2, 1)
        rho = rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]
        rho -= 0.3 * np.eye(k) / k
        m = np.block([[rho.real, -rho.imag], [rho.imag, rho.real]])
        got = ttomo.models.project_psd_embedded(
            torch.from_numpy(m.astype(np.float32))).numpy()
        ev, V = np.linalg.eigh(m)
        ev = np.clip(ev, 0.0, None)
        ev = 2.0 * ev / ev.sum(-1, keepdims=True)
        want = np.einsum("nab,nb,ncb->nac", V, ev, V)
        assert np.abs(got - want).max() < 3e-6, d


@pytest.mark.parametrize("kind", ["state2", "state3", "process1"])
def test_prior_samples_are_physical_and_match_jax_purity(kind):
    jm, tm, jp, tp = _models(kind)
    n = 5000
    x_t = tp.sample(_gen(4), n)
    x_j = np.asarray(jp.sample(jax.random.key(4), n))
    assert x_t.shape == (n, tm.n_modelparams) and x_t.is_contiguous()
    assert bool(tm.are_models_valid(x_t).all())
    assert _min_eig(tm.basis, x_t.numpy()).min() > -1e-5
    # Tr ρ² = 1/d + ‖x‖² in an orthonormal basis
    purity_t = 1 / tm.dim + float((x_t ** 2).sum(1).mean())
    purity_j = 1 / tm.dim + float((x_j ** 2).sum(1).mean())
    assert abs(purity_t - purity_j) < 0.01
    if kind == "process1":
        # trace preserving: the Choi state's input marginal is I/d
        rho = tm.modelparams_to_states(x_t[:200])
        d = tm.hilbert_dim
        marg = np.einsum("nkaia->nki", rho.reshape(-1, d, d, d, d))
        np.testing.assert_allclose(marg, np.broadcast_to(
            np.eye(d) / d, marg.shape), atol=2e-5)


def test_redit_prior_is_real_and_physical():
    b = ttomo.pauli_basis(2)
    x = ttomo.GinibreReditDistribution(b).sample(_gen(0), 500)
    rho = b.modelparams_to_state(torch.cat(
        [torch.full((500, 1), 0.5), x], 1).numpy())
    assert np.abs(rho.imag).max() < 1e-6
    assert bool(ttomo.TomographyModel(b).are_models_valid(x).all())


def test_diffusive_update_timestep_statistics_match_jax():
    rate, n = 0.01, 10_000
    jb, tb = jtomo.pauli_basis(2), ttomo.pauli_basis(2)
    jm = jtomo.DiffusiveTomographyModel(jb, diffusion_rate=rate)
    tm = ttomo.DiffusiveTomographyModel(tb, diffusion_rate=rate)
    assert tm.is_time_dependent and jm.is_time_dependent
    # states well inside the cone: a diffusion step leaves them there
    mp = np.full((n, 15), 0.02, np.float32)
    eps_j = {"meas": jnp.zeros((1, 16)), "t": jnp.full((1,), 4.0)}
    eps_t = {"meas": torch.zeros((1, 16)), "t": torch.full((1,), 4.0)}
    step_j = np.asarray(jm.update_timestep(
        jax.random.key(0), jnp.asarray(mp), eps_j))[:, :, 0] - mp
    step_t = (tm.update_timestep(_gen(0), torch.from_numpy(mp), eps_t)
              [:, :, 0].numpy() - mp)
    for step in (step_j, step_t):
        assert abs(step.mean()) < 4e-4
        assert abs(step.std() / (rate * 2.0) - 1) < 0.03
    # near the boundary both project the leavers back inside the cone
    edge = np.asarray(jtomo.GinibreDistribution(jb, rank=1).sample(
        jax.random.key(1), 500))
    out = tm.update_timestep(_gen(1), torch.tensor(edge), eps_t)
    assert out.shape == (500, 15, 1)
    assert bool(tm.are_models_valid(out[:, :, 0]).all())
    assert tm.projection_count >= 1


def test_fidelity_and_channel_action_match_jax():
    jm, tm, jp, _ = _models("process1")
    mp = np.asarray(jp.sample(jax.random.key(5), 50))
    sigma = np.asarray(jm.modelparams_to_states(jnp.asarray(mp[:1])))[0]
    np.testing.assert_allclose(tm.fidelity_with(mp, sigma),
                               np.asarray(jm.fidelity_with(mp, sigma)),
                               atol=1e-5)
    rho_in = np.array([[0.7, 0.2j], [-0.2j, 0.3]], np.complex64)
    np.testing.assert_allclose(tm.apply_channel(mp, rho_in),
                               jm.apply_channel(mp, rho_in), atol=1e-5)


def _updaters(nq=2):
    jm = jtomo.TomographyModel(jtomo.pauli_basis(nq))
    tm = ttomo.TomographyModel(ttomo.pauli_basis(nq))
    ju = JaxSMCUpdater(jm, 64, jtomo.GinibreDistribution(jm.basis))
    tu = qt.SMCUpdater(tm, 64, ttomo.GinibreDistribution(tm.basis),
                       device="cpu")
    return ju, tu


def test_heuristic_tables_match_jax():
    ju, tu = _updaters()
    jh, th = (jtomo.RandomPauliHeuristic(ju),
              ttomo.RandomPauliHeuristic(tu))
    assert np.array_equal(th.proj_coords.numpy(),
                          np.asarray(jh.proj_coords))
    js, ts = (jtomo.RandomStabilizerStateHeuristic(ju),
              ttomo.RandomStabilizerStateHeuristic(tu))
    assert np.array_equal(ts.stabilizer_coords.numpy(),
                          np.asarray(js.stabilizer_coords))


def test_random_pauli_proposals_cover_the_table_uniformly():
    _, tu = _updaters()
    h = ttomo.RandomPauliHeuristic(tu, other_fields={"t": 2.0})
    picks = []
    for idx in range(1500):
        eps = h(idx)
        assert eps["meas"].shape == (1, 16) and float(eps["t"]) == 2.0
        picks.append(int(torch.nonzero(
            (h.proj_coords == eps["meas"]).all(1))[0]))
    counts = np.bincount(picks, minlength=15)
    assert counts.min() > 60 and counts.max() < 150  # 100 expected


def test_stabilizer_and_product_proposals_are_valid_effects():
    """Every proposed effect is a rank-1 projector in the model's basis,
    and the product of per-qubit stabilizer proposals is one too."""
    _, tu = _updaters()
    tb = tu.model.basis
    sub = qt.SMCUpdater(ttomo.TomographyModel(ttomo.pauli_basis(1)), 16,
                        ttomo.GinibreDistribution(ttomo.pauli_basis(1)),
                        device="cpu")
    for h in (ttomo.RandomStabilizerStateHeuristic(tu),
              ttomo.ProductHeuristic(
                  tu, tb, [ttomo.RandomStabilizerStateHeuristic] * 2,
                  sub_updaters=[sub, sub])):
        for idx in range(20):
            E = tb.modelparams_to_state(h(idx)["meas"].numpy())[0]
            np.testing.assert_allclose(E @ E, E, atol=1e-5)
            assert abs(np.trace(E) - 1) < 1e-5
    with pytest.raises(ValueError):
        ttomo.ProductHeuristic(tu, tb, [ttomo.RandomPauliHeuristic] * 2)


def test_performance_warning_is_exported_and_a_user_warning():
    from qinfer_tpu._exceptions import PerformanceWarning as JaxWarning

    assert "PerformanceWarning" in qt.__all__
    assert issubclass(qt.PerformanceWarning, UserWarning)
    assert qt.PerformanceWarning.__name__ == JaxWarning.__name__


def test_performance_warning_gates_on_the_card_past_embedded_32(monkeypatch):
    """As the JAX package's gate (``tests/test_round4_fixes.py``): an
    embedded dimension past 32 warns where the projections would run on
    the card, and is silent on the CPU and at or under the gate."""
    import warnings

    wide, gate = ttomo.pauli_basis(5), ttomo.pauli_basis(4)  # 64, 32
    assert not torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.simplefilter("error", qt.PerformanceWarning)
        ttomo.TomographyModel(wide)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.warns(qt.PerformanceWarning, match="torch.linalg.eigh"):
        ttomo.TomographyModel(wide)
    with warnings.catch_warnings():
        warnings.simplefilter("error", qt.PerformanceWarning)
        ttomo.TomographyModel(gate)
