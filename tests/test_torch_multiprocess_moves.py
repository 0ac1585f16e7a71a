"""The rest of the engine on a particle mesh across processes: 2 gloo
ranks of ``python -m qinfer_tpu_torch.parallel.worker --cpu`` (started
once for the module by the launcher of ``test_torch_multiprocess.py``)
run each of the engine's features on an ensemble sharded over them, and
each is held against the same run on a one-process mesh of 2 shards
(``qinfer_tpu_torch.parallel.runs``: the same experiments and outcomes,
drawn up front, and the same two-level resampler in both layouts).

Tolerances, and why:

* Before the first resample the layouts draw the same values (the
  replicated generator's and each shard's own streams), so the
  generator's state before each step and the particles' bits are equal;
  the weights are normalized by the ranks' partial sums, summed over the
  group, where one process sums the whole ensemble, so the
  normalizations and estimates agree to rtol 1e-5 (float32 sums in
  another order), and the first resample comes at the same step.
* After it the resample's float order parts the runs' bits, and they are
  two draws of one law: the final estimates within 5 combined posterior
  sd, the resample counts within ``RESAMPLE_BAR`` of
  ``test_torch_multiprocess.py``, one move call a resample, the
  Metropolis acceptance, and that of one more waste-free move of the
  final ensemble, within 0.05 of the one-process run's (a sweep's mean
  over 4096 particles has a standard error under 0.008), the first
  resample's KL divergence within rtol 1e-3 (one slot of 4096 moved
  changes it by ~1e-4), ALE's rounds equal through the first resample
  (its stopping rule reads the whole ensemble's worst cell).
* ``est_meanfn`` and ``est_kl_divergence`` are read before any resample:
  rtol 1e-5 and 1e-4 (the kernel density sums over 4096 points).
* The coin runs (Metropolis and waste-free: 20 steps of 50 shots at p =
  0.7, a conjugate Beta posterior of sd ~0.014, the uniform prior's mean
  15 sd away) are held to that posterior in both layouts, and against
  the JAX package run unsharded on the CPU from the same outcomes. The
  bars come from 10 updater seeds of each package at this size (CPU):
  the posterior mean read within 0.06 posterior sd of the Beta mean and
  the sd within 0.974-1.031 of the Beta sd; the mean Metropolis
  acceptance (compressed record) 0.3554-0.3596 in the port and
  0.3547-0.3634 in JAX; the acceptance of one more waste-free move of the
  final ensemble 0.443-0.462 and 0.428-0.464. So: the mean within
  ``Z_BAR`` = 0.25 posterior sd of the Beta mean, and the two packages'
  means within 0.25 of it of each other; each sd within ``SD_BAR`` = 15 %
  of the Beta sd and of the other package's; the Metropolis acceptances
  within 0.03 and the waste-free within 0.06 (the kernels share the
  proposal rule, not the stream). A Metropolis or waste-free step that
  accepts against the likelihood (its log-uniform compared with the
  ratio + 5) reads the mean 0.63-0.87 sd off and the sd 1.52-1.62 times
  the Beta's, and moves the acceptances by 0.045-0.2.
"""

import contextlib

import jax
import numpy as np
import pytest
import scipy.stats as st
import torch

import qinfer_tpu as q

from qinfer_tpu_torch.parallel import ParticleMesh
from qinfer_tpu_torch.parallel import runs

from test_torch_multiprocess import RESAMPLE_BAR, _launch, _replicated

N, STEPS = 4096, 20
#: the coin runs' bars against the Beta posterior and the JAX package
#: (the module's docstring says whence)
Z_BAR, SD_BAR = 0.25, 0.15
MH_ACCEPTANCE_BAR, WASTE_FREE_ACCEPTANCE_BAR = 0.03, 0.06
COIN_RUNS = ("mh_fixed", "mh_adaptive", "mh_compressed", "waste_free")
#: est_meanfn and est_kl_divergence are read before the precession run's
#: first resample (its step 6)
STEPS_OF = {"est_meanfn": 5, "est_kl_divergence": 5}


def _steps(name):
    return STEPS_OF.get(name, STEPS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's ``runs`` lines, by run."""
    store = tmp_path_factory.mktemp("moves")
    spec = ",".join(f"{name}:{N}:{_steps(name)}" for name in runs.FEATURES)
    results = _launch(2, "runs", store, "--runs", spec)
    out = []
    for res in results:
        out.append({line["run"]: line for line in res["runs"]})
    return out


@contextlib.contextmanager
def one_thread():
    """Run torch on one thread, as each rank does (small CPU runs slow
    down by tens of times when their threads share the cores with other
    test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_process():
    """Each feature's run on a one-process mesh of 2 CPU shards."""
    mesh = ParticleMesh(["cpu"] * 2)
    with one_thread():
        return {name: runs.drive(mesh, runs.make_run(
            mesh, name, N, _steps(name)), _steps(name))
            for name in runs.FEATURES}


def _coin_record():
    """The coin runs' outcomes (``runs.COIN``: shots a step at p = 0.7,
    from the runs' world generator) as host ints."""
    mesh = ParticleMesh(["cpu"] * 2)
    run = runs.make_run(mesh, "mh_compressed", N, STEPS)
    out = []
    for k in range(STEPS):
        run.step(k)
        out.append(int(run.updater.data_record[-1].reshape(-1)[0]))
    return out


@pytest.fixture(scope="module")
def coin():
    """The coin's outcomes and its Beta posterior under the uniform
    prior."""
    with one_thread():
        counts = _coin_record()
    succ, shots = sum(counts), runs.COIN[1] * STEPS
    return counts, st.beta(1 + succ, 1 + shots - succ)


def _held_to_the_posterior(rec, post, where):
    """A coin run's final mean within ``Z_BAR`` posterior sd of the Beta
    mean, and its sd within ``SD_BAR`` of the Beta sd."""
    z = (rec["final_est"][0] - post.mean()) / post.std()
    assert abs(z) < Z_BAR, f"{where}: mean {z:+.3f} posterior sd off"
    ratio = rec["final_sd"][0] / post.std()
    assert abs(ratio - 1) < SD_BAR, f"{where}: sd {ratio:.3f} of the Beta's"


@pytest.mark.parametrize("name", runs.FEATURES)
def test_feature_on_two_ranks_matches_the_one_process_mesh(ranks,
                                                           one_process,
                                                           coin, name):
    lines = [r[name] for r in ranks]
    assert _replicated(lines[0]) == _replicated(lines[1])
    a, one = lines[0], one_process[name]
    assert a["particles"] == N and a["local_rows"] == N // 2 and a["finite"]
    steps = len(one["norm"])
    first = runs.first_resample(one)
    assert runs.first_resample(a) == first
    upto = steps if first is None else first + 1
    # the same draws through the first resample's inputs
    assert a["generator"][:upto] == one["generator"][:upto]
    for r, line in enumerate(lines):
        assert line["local_x"][0][:upto] == one["local_x"][r][:upto]
    assert runs.rel_diff(a["norm"][:upto], one["norm"][:upto]) <= 1e-5
    assert runs.rel_diff(a["est"][:upto - 1], one["est"][:upto - 1]) <= 1e-5
    # then by law
    sd = runs.combined_sd(a, one)
    for x, y, s in zip(a["final_est"], one["final_est"], sd):
        assert abs(x - y) < 5 * s
    assert abs(a["resample_count"] - one["resample_count"]) <= RESAMPLE_BAR
    if name.startswith("mh_"):
        assert first is not None
        assert len(a["acceptance"]) == a["resample_count"] >= 1
        assert abs(np.mean(a["acceptance"])
                   - np.mean(one["acceptance"])) < 0.05
    if name in ("waste_free", "time_dependent", "keyed"):
        assert first is not None and a["resample_count"] >= 1
    if name in COIN_RUNS:
        # a move wrong in both layouts shows against the posterior
        _held_to_the_posterior(a, coin[1], f"{name} on the ranks")
        _held_to_the_posterior(one, coin[1], f"{name} in one process")
    if name == "waste_free":
        assert abs(a["waste_free_acceptance"]
                   - one["waste_free_acceptance"]) < 0.05
    if name == "keyed":
        assert a["rounds"][:upto] == one["rounds"][:upto]
    if name == "diagnostics":
        assert len(a["divergences"]) == a["resample_count"] >= 1
        np.testing.assert_allclose(a["divergences"][0],
                                   one["divergences"][0], rtol=1e-3)
    if name == "est_meanfn":
        assert first is None
        for k in ("sq", "cos"):
            np.testing.assert_allclose(a["meanfn"][k], one["meanfn"][k],
                                       rtol=1e-5)
        np.testing.assert_allclose(a["meanfn"]["cos"][0], np.cos(
            a["final_est"][0]), atol=0.1)
    if name == "est_kl_divergence":
        assert first is None
        np.testing.assert_allclose(a["kl"], one["kl"], rtol=1e-4)
        assert all(v > 0 for v in a["kl"])


@pytest.mark.parametrize("name", ["mh_compressed", "waste_free"])
def test_moves_on_two_ranks_match_the_jax_package_by_law(ranks, coin, name):
    """One Metropolis and one waste-free run on the ranks against the JAX
    package's unsharded updater on the same outcomes, both against the
    conjugate Beta posterior: posterior mean and sd, and the acceptance
    (the Metropolis moves' over the run; one more waste-free move of the
    final ensemble, which neither updater records)."""
    from qinfer_tpu.rejuvenation import waste_free_rejuvenate_binomial

    counts, post = coin
    shots = runs.COIN[1]
    opts = {"mh_compressed": dict(n_mcmc_moves=3, mcmc_adapt=True,
                                  compress_mcmc_record=True,
                                  mcmc_canonicalize=False),
            "waste_free": dict(waste_free_stages=runs.WASTE_FREE_STAGES,
                               compress_mcmc_record=True,
                               zero_weight_policy="reset")}[name]
    ju = q.SMCUpdater(q.BinomialModel(q.CoinModel(), n_meas_max=shots), N,
                      q.UniformDistribution([[0.0, 1.0]]), seed=5, **opts)
    eps = np.zeros((1,), dtype=ju.model.expparams_dtype)
    eps["n_meas"] = shots
    for c in counts:
        ju.update(c, eps)
    a = ranks[0][name]
    j = {"final_est": [float(np.asarray(ju.est_mean())[0])],
         "final_sd": [float(np.sqrt(np.asarray(
             ju.est_covariance_mtx())[0, 0]))]}
    _held_to_the_posterior(a, post, f"{name} on the ranks")
    _held_to_the_posterior(j, post, f"{name} in the JAX package")
    assert abs(a["final_est"][0] - j["final_est"][0]) < Z_BAR * post.std()
    assert abs(a["final_sd"][0] / j["final_sd"][0] - 1) < SD_BAR
    assert ju.resample_count >= 1 and a["resample_count"] >= 1
    if name == "mh_compressed":
        assert ju.mcmc_acceptance_record and a["acceptance"]
        assert abs(np.mean(a["acceptance"])
                   - np.mean(ju.mcmc_acceptance_record)) < MH_ACCEPTANCE_BAR
    else:
        pool_eps, succ, trials = ju._pool_arrays()
        _, _, acc = waste_free_rejuvenate_binomial(
            ju.model, ju.prior, jax.random.key(5), ju._state.weights,
            ju._state.locations, succ, trials, pool_eps,
            ju.waste_free_stages, proposal_scale=ju.mcmc_proposal_scale,
            canonicalize=ju.mcmc_canonicalize)
        assert abs(a["waste_free_acceptance"]
                   - float(acc)) < WASTE_FREE_ACCEPTANCE_BAR


def test_waste_free_refuses_a_mesh_that_does_not_divide_its_chains():
    """M = n/P chains, M/D a shard: a mesh of 3 shards cannot split the
    1024 chains of 3072 particles in 3 stages."""
    from qinfer_tpu_torch import rejuvenation as rj
    import qinfer_tpu_torch as qt

    model = qt.BinomialModel(qt.CoinModel(), n_meas_max=2)
    prior = qt.UniformDistribution([[0.0, 1.0]])
    w = torch.full((3072,), 1 / 3072)
    x = torch.rand((3072, 1), generator=torch.Generator().manual_seed(0))
    record = (torch.tensor([1], dtype=torch.int32),
              torch.tensor([2], dtype=torch.int32),
              {"exp_num": torch.zeros((1,), dtype=torch.int32)})
    with pytest.raises(ValueError, match="the mesh size must divide M"):
        rj.waste_free_rejuvenate_binomial(
            model, prior, torch.Generator().manual_seed(1), w, x, *record, 3,
            mesh=ParticleMesh(["cpu"] * 3))
    # unsharded, and on a mesh of 2 shards (512 chains a shard), it runs
    for mesh in (None, ParticleMesh(["cpu"] * 2)):
        w2, x2, acc = rj.waste_free_rejuvenate_binomial(
            model, prior, torch.Generator().manual_seed(1), w, x, *record, 3,
            mesh=mesh)
        assert x2.shape == x.shape and torch.isfinite(acc)
        assert torch.equal(w2, torch.full((3072,), 1 / 3072))




def test_particle_streams_draw_each_shard_from_its_own_generator():
    """A one-process mesh's streams: shard s's block is the draw of a
    generator seeded by the replicated generator's state and s (so a rank
    holding shard s draws it too), the replicated generator then draws
    once, and the next streams differ; unsharded, the generator itself."""
    from qinfer_tpu_torch.abstract_model import per_particle
    from qinfer_tpu_torch.parallel.mesh import (particle_streams,
                                                shard_generators)

    mesh = ParticleMesh(["cpu"] * 4)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    like = torch.zeros((8, 3))

    def normals(gen, x):
        return torch.randn(x.shape, generator=gen)

    drawn = per_particle(particle_streams(g, mesh), normals, like)
    again = torch.Generator()
    again.set_state(state)
    want = torch.cat([normals(s, like[:2]) for s in shard_generators(
        again, mesh, torch.device("cpu"))])
    assert torch.equal(drawn, want)
    assert torch.equal(g.get_state(), again.get_state())
    assert not torch.equal(per_particle(particle_streams(g, mesh), normals,
                                        like), drawn)
    g2 = torch.Generator().manual_seed(11)
    assert particle_streams(g2, None) is g2
    assert torch.equal(per_particle(g2, normals, like), torch.randn(
        (8, 3), generator=torch.Generator().manual_seed(11)))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_waste_free_seeds_are_the_global_systematic_draw(shards):
    """With weights whose sums float32 adds exactly (multiples of 2⁻²⁰),
    each shard counting its own slots from its offset in the global CDF
    gives the one-ensemble counting ancestors, slot for slot, in global
    order."""
    from qinfer_tpu_torch import rejuvenation as rj

    rng = np.random.default_rng(shards)
    n, M = 4096, 512
    w = torch.from_numpy(rng.integers(0, 64, n).astype(np.float32))
    w[rng.integers(0, n, 40)] = 0.0
    w = w / 2.0 ** 20
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    for u in (0.0, 0.3183, 0.9999):
        u = torch.tensor(u)
        seeds = rj._sharded_seeds(u, w, x, M, ParticleMesh(["cpu"] * shards))
        want = x[rj._counting_ancestors(u, w / w.sum(), M)]
        assert torch.equal(seeds, want)
