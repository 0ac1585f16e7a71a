"""The port's particle mesh against the JAX package's, case by case after
``tests/test_parallel.py``.

The port's mesh is ``ParticleMesh(["cpu"] * 8)``: 8 shards of one
ensemble on the CPU (the JAX side runs on the 8 virtual CPU devices that
``conftest.py`` forces). Sharding is a layout there, so a sharded updater
equals the unsharded one to the bit, resamples included. Against JAX's
sharded updater, from the same NumPy prior locations and outcomes with
no resampling: the posterior mean to atol 1e-4 and the covariance to
1e-5, the information gains to rtol 1e-5 and the Bayes risks to 2e-3
(``tests/test_parallel.py``'s bars: the JAX side's sharded reductions
group otherwise). Stochastic paths draw from different streams and are
held to what both must reach.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats as st
import torch

import qinfer_tpu as q
from qinfer_tpu.parallel import ParticleMesh as JaxParticleMesh
from qinfer_tpu.smc import SMCState as JaxSMCState

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import expdesign_bench as eb
from qinfer_tpu_torch import scaling_bench as sb
from qinfer_tpu_torch.checkpoint import load_updater, save_updater
from qinfer_tpu_torch.convert import state_from_numpy
from qinfer_tpu_torch.parallel import (DirectViewParallelizedModel,
                                       ParticleMesh, initialize_multihost,
                                       make_particle_sharding)
from qinfer_tpu_torch.perf_testing import perf_test_scan, perf_test_scan_batch

CPU8 = ["cpu"] * 8


@pytest.fixture
def pm():
    return ParticleMesh(CPU8)


def _prec():
    return qt.SimplePrecessionModel(), qt.UniformDistribution([[0.0, 1.0]])


def _run_precession(u, truth, n_steps, seed, check=True):
    """``n_steps`` updates at t = (9/8)^k / 10 with outcomes simulated at
    ``truth`` from a generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for k in range(n_steps):
        eps = {"t": torch.tensor([(9 / 8) ** k / 10])}
        o = u.model.simulate_experiment(g, torch.tensor([[truth]]), eps)
        u.update(o, eps, check_for_resample=check)
    return u


def _on_mesh(u, mesh):
    """The updater's ensemble lies on the mesh: its sharding, its device,
    equal shards."""
    assert u.sharding == mesh.particle_sharding
    for t in (u.particle_weights, u.particle_locations):
        assert t.device == mesh.device
        assert mesh.shard(t).shape[:2] == (8, u.n_particles // 8)


def test_mesh_properties_match_jax(pm):
    jm = JaxParticleMesh()
    assert pm.n_devices == jm.n_devices == 8
    for n in (1000, 1001, 7, 8):
        assert pm.pad_particles(n) == jm.pad_particles(n)
    assert pm.pad_particles(1001) == 1008
    assert repr(pm) == repr(jm) == "<ParticleMesh 8 devices axis='particles'>"
    assert pm.device == torch.device("cpu")
    assert pm.particle_sharding.spec == ("particles",)
    assert pm.location_sharding.spec == ("particles", None)
    assert pm.replicated.spec == ()
    assert pm.particle_sharding == pm.particle_sharding
    assert pm.particle_sharding != ParticleMesh(CPU8).particle_sharding
    assert make_particle_sharding(CPU8, "x").spec == ("x",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParticleMesh()


def test_mesh_collectives_match_jax_shard_map(pm):
    """psum, all_gather, ppermute and axis_index on the shard-stacked view
    against JAX's collectives under ``shard_map`` on 8 devices."""
    from jax.sharding import PartitionSpec as P

    x = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    jm = JaxParticleMesh()

    def kernel(xl):
        idx = jax.lax.axis_index("particles")
        perm = [(s, (s + 3) % 8) for s in range(8)]
        return (jax.lax.psum(xl.sum(axis=0), "particles")[None],
                jax.lax.all_gather(xl.sum(axis=0), "particles")[None],
                jax.lax.ppermute(xl, "particles", perm),
                idx[None])

    f = jax.shard_map(kernel, mesh=jm.mesh, in_specs=P("particles", None),
                      out_specs=(P("particles"), P("particles"),
                                 P("particles", None), P("particles")),
                      check_vma=False)
    jsum, jgat, jperm, jidx = (np.asarray(a) for a in f(jnp.asarray(x)))
    v = pm.shard(torch.from_numpy(x))
    assert v.shape == (8, 8, 3)
    np.testing.assert_allclose(pm.psum(v.sum(dim=1)).numpy(), jsum[0],
                               rtol=1e-6)
    np.testing.assert_allclose(pm.all_gather(v.sum(dim=1)).numpy(), jgat[0],
                               rtol=1e-6)
    np.testing.assert_array_equal(pm.unshard(pm.ppermute(v, 3)).numpy(),
                                  jperm)
    np.testing.assert_array_equal(pm.axis_index().numpy(), jidx)
    assert torch.equal(pm.unshard(v), torch.from_numpy(x))


def test_sharded_updater_converges_on_the_mesh(pm):
    model, prior = _prec()
    u = qt.SMCUpdater(model, 8000, prior, seed=1,
                      sharding=pm.particle_sharding)
    assert u.device == torch.device("cpu")
    _run_precession(u, 0.62, 40, 2)
    std = float(torch.sqrt(u.est_covariance_mtx()[0, 0]))
    assert abs(float(u.est_mean()[0]) - 0.62) < 6 * std + 0.01
    assert u.resample_count > 0
    _on_mesh(u, pm)


def test_sharded_updater_equals_unsharded_to_the_bit(pm):
    """Resampling on (plain Liu-West): the same bits with and without the
    mesh, every weight and location."""
    model, prior = _prec()
    runs = [_run_precession(
        qt.SMCUpdater(model, 4000, prior, seed=7, sharding=s, device="cpu"),
        0.5, 30, 3) for s in (pm.particle_sharding, None)]
    assert runs[0].resample_count == runs[1].resample_count > 0
    for name in ("particle_weights", "particle_locations"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    assert torch.equal(runs[0].state.log_total_likelihood,
                       runs[1].state.log_total_likelihood)


def _both_sharded(n, seed):
    """A JAX updater sharded over the 8 virtual devices and a port
    updater sharded over 8 CPU shards, both holding the same NumPy prior
    locations."""
    jm = JaxParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    ju = q.SMCUpdater(model, n, prior, seed=seed,
                      sharding=jm.particle_sharding)
    locs = np.random.default_rng(seed).random((n, 1), dtype=np.float32)
    ju.state = ju._shard_state(JaxSMCState.initial(jnp.asarray(locs),
                                                   jax.random.key(seed)))
    pm = ParticleMesh(CPU8)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), n,
                       qt.UniformDistribution([[0.0, 1.0]]), seed=seed,
                       sharding=pm.particle_sharding)
    tu.state = state_from_numpy(
        {f: np.asarray(getattr(ju.state, f)) for f in ju.state._fields
         if f != "key"}, sharding=pm.particle_sharding)
    return ju, tu


def test_sharded_updater_matches_jax_sharded_updater():
    """15 steps from the same prior locations with the same outcomes and
    no resampling."""
    ju, tu = _both_sharded(4000, 7)
    rng = np.random.default_rng(3)
    for k in range(15):
        t = float(k + 1)
        o = int(rng.random() < np.cos(0.5 * t / 2) ** 2) ^ 1
        ju.update(o, {"t": jnp.array([t])}, check_for_resample=False)
        tu.update(o, {"t": torch.tensor([t])}, check_for_resample=False)
    assert len(ju.particle_weights.sharding.device_set) == 8
    np.testing.assert_allclose(tu.est_mean().numpy(),
                               np.asarray(ju.est_mean()), atol=1e-4)
    np.testing.assert_allclose(tu.est_covariance_mtx().numpy(),
                               np.asarray(ju.est_covariance_mtx()), atol=1e-5)


def test_sharded_design_scores_match_jax_sharded_scores():
    """BASELINE config 5's scorers on one sharded ensemble (five JAX
    updates, carried to the port's mesh): information gain to rtol 1e-5,
    Bayes risk to 2e-3."""
    ju, tu = _both_sharded(4000, 21)
    for k in range(5):
        ju.update(1, {"t": jnp.array([(9 / 8) ** k])})
    tu.state = state_from_numpy(
        {f: np.asarray(getattr(ju.state, f)) for f in ju.state._fields
         if f != "key"}, sharding=tu.sharding)
    cand = np.geomspace(0.5, 50.0, 12).astype(np.float32)
    jc, tc = {"t": jnp.asarray(cand)}, {"t": torch.from_numpy(cand)}
    eig = tu.expected_information_gain(tc).numpy()
    assert eig.shape == (12,) and np.all(np.isfinite(eig))
    np.testing.assert_allclose(
        eig, np.asarray(ju.expected_information_gain(jc)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(tu.bayes_risk(tc).numpy(),
                               np.asarray(ju.bayes_risk(jc)), rtol=2e-3,
                               atol=1e-6)


def test_sharded_perf_test_scan_loop(pm):
    model, prior = _prec()
    u, rec = perf_test_scan(model, 8000, prior, 30, seed=11,
                            sharding=pm.particle_sharding)
    assert float(rec["loss"][-1]) < 0.05
    _on_mesh(u, pm)
    plain, rec0 = perf_test_scan(model, 8000, prior, 30, seed=11,
                                 device="cpu")
    assert torch.equal(rec["loss"], rec0["loss"])
    assert torch.equal(u.particle_locations, plain.particle_locations)


def test_shard_updater_places_an_existing_updater(pm):
    model, prior = _prec()
    u = qt.SMCUpdater(model, 800, prior, seed=0, device="cpu")
    assert u.sharding is None
    assert pm.shard_updater(u) is u
    _on_mesh(u, pm)
    u.update(0, {"t": torch.tensor([1.0])})
    assert np.isfinite(float(u.est_mean()[0]))
    _on_mesh(u, pm)
    with pytest.raises(ValueError, match="pad_particles"):
        pm.shard_updater(qt.SMCUpdater(model, 801, prior, device="cpu"))


@pytest.mark.parametrize("moves", ["full", "compressed", "waste_free"])
def test_sharded_rejuvenation_keeps_the_sharding(pm, moves):
    """Resample-move with the full record, the compressed record and
    waste-free resample-move on the mesh: the conjugate Beta(71, 31)
    posterior, the sharding kept through ``batch_update``, ``resample()``
    and ``reset``."""
    model = qt.BinomialModel(qt.CoinModel(), n_meas_max=20)
    prior = qt.UniformDistribution([[0.0, 1.0]])
    opts = {"full": dict(n_mcmc_moves=5),
            "compressed": dict(n_mcmc_moves=5, compress_mcmc_record=True,
                               mcmc_canonicalize=False),
            "waste_free": dict(compress_mcmc_record=True,
                               waste_free_stages=8,
                               zero_weight_policy="reset")}[moves]
    u = qt.SMCUpdater(model, 4096, prior, seed=5, resample_thresh=0.9,
                      sharding=pm.particle_sharding, **opts)
    counts = torch.tensor([14, 15, 13, 14, 14], dtype=torch.int32)
    eps = {"exp_num": torch.zeros(5, dtype=torch.int32),
           "n_meas": torch.full((5,), 20, dtype=torch.int32)}
    u.batch_update(counts, eps, resample_interval=1)
    assert u.resample_count >= 1
    ref = st.beta(71, 31)
    assert abs(float(u.est_mean()[0]) - ref.mean()) < 0.02
    assert abs(float(torch.sqrt(u.est_covariance_mtx()[0, 0]))
               - ref.std()) < 0.015
    _on_mesh(u, pm)
    u.resample()
    _on_mesh(u, pm)
    u.reset()
    _on_mesh(u, pm)


def test_checkpoint_round_trip_keeps_the_sharding(pm, tmp_path):
    model, prior = _prec()
    a = _run_precession(qt.SMCUpdater(model, 800, prior, seed=2,
                                      sharding=pm.particle_sharding),
                        0.4, 10, 1)
    save_updater(tmp_path / "ck", a)
    b = qt.SMCUpdater(model, 800, prior, seed=9,
                      sharding=pm.particle_sharding)
    load_updater(tmp_path / "ck", b)
    _on_mesh(b, pm)
    assert torch.equal(b.particle_locations, a.particle_locations)
    for u in (a, b):
        u.update(1, {"t": torch.tensor([3.0])})
    assert torch.equal(b.particle_weights, a.particle_weights)
    # an ensemble that does not split into the mesh's shards is refused,
    # and the updater is left as it was
    save_updater(tmp_path / "odd", qt.SMCUpdater(model, 804, prior,
                                                 device="cpu"))
    before = b.particle_locations
    with pytest.raises(ValueError, match="pad_particles"):
        load_updater(tmp_path / "odd", b)
    assert b.particle_locations is before


def test_trial_mesh_equals_the_device_list():
    """``perf_test_scan_batch`` on a ``'trials'`` ParticleMesh runs what
    the list of its devices runs, to the bit; a mesh of another axis is
    refused."""
    model, prior = _prec()
    kw = dict(n_trials=4, seed=1)
    rec = perf_test_scan_batch(
        model, 256, prior, 12,
        mesh=ParticleMesh(["cpu", "cpu"], axis_name="trials"), **kw)
    want = perf_test_scan_batch(model, 256, prior, 12, mesh=["cpu", "cpu"],
                                **kw)
    assert set(rec) == set(want)
    for k in want:
        assert torch.equal(rec[k], want[k]), k
    with pytest.raises(ValueError, match="axis"):
        perf_test_scan_batch(model, 256, prior, 2, mesh=ParticleMesh(CPU8),
                             **kw)


def test_distinct_devices_shard_trials_but_not_one_ensemble():
    mesh = ParticleMesh(["cpu", "meta"], axis_name="trials")
    assert mesh.n_devices == 2
    assert [d.type for d in mesh.devices] == ["cpu", "meta"]
    for get in (lambda: mesh.particle_sharding, lambda: mesh.device,
                lambda: ParticleMesh(["cpu", "meta"]).location_sharding):
        with pytest.raises(NotImplementedError,
                           match="distinct devices of one process"):
            get()


def test_initialize_multihost_returns_alone_and_refuses_a_coordinator():
    # one process: nothing to join; a coordinator with a backend the port
    # has no route for is refused before any rendezvous (a group across
    # processes is tested in tests/test_torch_multiprocess.py)
    assert initialize_multihost() is None
    assert initialize_multihost(num_processes=1) is None
    with pytest.raises(ValueError, match="gloo"):
        initialize_multihost("localhost:1234", 2, 0, backend="mpi")


def test_updater_refuses_a_size_or_device_the_mesh_cannot_take(pm):
    model, prior = _prec()
    jm = JaxParticleMesh()
    with pytest.raises(ValueError):
        q.SMCUpdater(q.SimplePrecessionModel(), 1001,
                     q.UniformDistribution([[0.0, 1.0]]),
                     sharding=jm.particle_sharding)
    with pytest.raises(ValueError, match=r"pad_particles\(1001\) = 1008"):
        qt.SMCUpdater(model, 1001, prior, sharding=pm.particle_sharding)
    with pytest.raises(ValueError, match="disagrees"):
        qt.SMCUpdater(model, 1008, prior, sharding=pm.particle_sharding,
                      device="meta")
    with pytest.raises(ValueError, match="particle sharding"):
        qt.SMCUpdater(model, 1008, prior, sharding=pm.location_sharding)
    with pytest.raises(TypeError, match="MeshSharding"):
        qt.SMCUpdater(model, 1008, prior, sharding="particles",
                      device="cpu")
    u = qt.SMCUpdater(model, 1008, prior, sharding=pm.particle_sharding,
                      device="cpu")
    with pytest.raises(ValueError, match="pad_particles"):
        u.reset(1001)


def test_expdesign_bench_virtual_mesh_is_the_unsharded_run():
    """``--virtual D`` rounds n down to a multiple of D and, on its mesh of
    one device, runs the unsharded run of that n to the bit."""
    mesh = ParticleMesh(["cpu"] * 3)
    r = eb.run_bench(4097, 8, 8, 0, mesh=mesh)
    want = eb.run_bench(4095, 8, 8, 0, device="cpu")
    assert r["particles"] == 4095 and r["mesh"] == {"shards": 3,
                                                    "distinct_devices": 1}
    assert want["mesh"] is None
    assert r["posterior_mean"] == want["posterior_mean"]
    assert torch.equal(r["state"].locations, want["state"].locations)
    assert eb.main(["--cpu", "--virtual", "8", "--particles", "4096"]) == 0


def test_scaling_bench_rehearses_both_legs(capsys):
    """Both legs at a tiny size on the CPU: a run at each D and seed, the
    efficiency beside D = 1, the flagship's fidelity above its prior
    mean's; the precession leg's JSON line."""
    dev = torch.device("cpu")
    runs, eff = sb.run_leg(sb.PrecessionLeg(dev, "butterfly"), [1, 2, 4],
                           2048, 32, 1)
    assert [r["shards"] for r in runs] == [1, 2, 4]
    assert [r["particles"] for r in runs] == [2048, 4096, 8192]
    assert eff["1"] == [1.0] and all(r["ok"] for r in runs)
    assert all(abs(r["est"] - 0.7) < 0.05 for r in runs)
    leg = sb.FlagshipLeg(dev)
    runs, _ = sb.run_leg(leg, [1, 2], 256, 20, 2)
    assert [(r["shards"], r["seed"]) for r in runs] == [(1, 0), (2, 0),
                                                        (1, 1), (2, 1)]
    assert all(r["fidelity"] > 0.69 for r in runs)
    assert sb.main(["--cpu", "--virtual", "2", "--particles-per-device",
                    "2048"]) == 0
    import json
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["virtual_mesh"] and out["distinct_devices"] == 1
    assert [r["shards"] for r in out["runs"]] == [1, 2]


class MockDirectView:
    """Serial stand-in for an ipyparallel DirectView (the reference's test
    pattern)."""

    def __init__(self, n_engines=4, fail=False):
        self.n = n_engines
        self.fail = fail
        self.apply_calls = 0
        self.purged = 0

    def __len__(self):
        return self.n

    def apply(self, f, *args):
        self.apply_calls += 1
        if self.fail:
            raise RuntimeError("engine lost")
        return f(*args)

    def purge_results(self, which):
        assert which == "all"
        self.purged += 1


def test_directview_matches_serial_and_jax():
    model = qt.SimplePrecessionModel()
    view = MockDirectView(4)
    par = DirectViewParallelizedModel(model, view, serial_threshold=1)
    assert par.host_only and par.n_engines == 4
    mps = torch.linspace(0, 1, 64)[:, None]
    eps = {"t": torch.tensor([1.0, 2.0])}
    got = par.likelihood(torch.tensor([0, 1]), mps, eps)
    assert view.apply_calls == 4  # one chunk per engine
    assert torch.equal(got, model.likelihood(torch.tensor([0, 1]), mps, eps))
    jpar = q.parallel.DirectViewParallelizedModel(
        q.SimplePrecessionModel(), MockDirectView(4), serial_threshold=1)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpar.likelihood(
            jnp.array([0, 1]), jnp.asarray(mps.numpy()),
            {"t": jnp.array([1.0, 2.0])})), atol=1e-6)
    assert DirectViewParallelizedModel(model, view).serial_threshold == 40
    assert DirectViewParallelizedModel(model, object()).n_engines == 1


def test_directview_runs_serially_below_the_threshold():
    view = MockDirectView(4)
    par = DirectViewParallelizedModel(qt.SimplePrecessionModel(), view,
                                      serial_threshold=1000)
    par.likelihood(torch.tensor([0]), torch.linspace(0, 1, 8)[:, None],
                   {"t": torch.tensor([1.0])})
    assert view.apply_calls == 0


def test_directview_drives_an_updater():
    model = qt.SimplePrecessionModel()
    view = MockDirectView(2)
    par = DirectViewParallelizedModel(model, view, purge_client=True,
                                      serial_threshold=1)
    u = _run_precession(qt.SMCUpdater(par, 400, qt.UniformDistribution(
        [[0.0, 1.0]]), seed=0, device="cpu"), 0.5, 10, 1)
    assert np.isfinite(float(u.est_mean()[0]))
    assert view.apply_calls >= 20 and view.purged == view.apply_calls // 2


def test_directview_failure_raises_instead_of_running_serially():
    """The JAX package warns and falls back to the serial model when
    ``apply`` fails; the port raises (and still purges)."""
    view = MockDirectView(4, fail=True)
    par = DirectViewParallelizedModel(qt.SimplePrecessionModel(), view,
                                      purge_client=True, serial_threshold=1)
    with pytest.raises(RuntimeError, match="engine lost"):
        par.likelihood(torch.tensor([0]), torch.linspace(0, 1, 64)[:, None],
                       {"t": torch.tensor([1.0])})
    assert view.apply_calls == 1 and view.purged == 1


def test_shard_updater_refuses_an_updater_on_another_device():
    """The updater's generator lives on its device, so the mesh must be
    there too."""
    model, prior = _prec()
    u = qt.SMCUpdater(model, 800, prior, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        ParticleMesh(["meta"] * 8).shard_updater(u)
    assert u.sharding is None and u.particle_weights.device.type == "cpu"
