"""The port's two-level distributed Liu-West resampler against the JAX
package's, after ``tests/test_distributed_resample.py``.

Exact where the path is deterministic: the level-1 ancestor shards and
the butterfly schedule (shifts and take masks) equal JAX's for D ∈ {4, 8,
16, 32} over its 60 adversarial mass patterns, and with a = 1 (no
kernel noise) the two-level fill at given u₁ and u₂ equals, to the bit,
the fill composed from JAX's public pieces (its level-1 ancestors, the
blocks delivered to their shards, its bit-copying counting fill per
block). There the offsets u₂ stay below the float32 rounding zone of
n/D − u (u > 0.99 at 512 slots a shard), where JAX's counting pass loses
its last slot and the port's keeps it (ROADMAP queue 3). Statistical
where the streams differ:
moments (atol 0.05), uniform weights, the rebalanced mass, validity, a
full SMC run, and the copy-count law against JAX's resampler within 4
Monte-Carlo errors (JAX's ``shard_map`` resampler runs in that test only,
at n = 4096).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.parallel import ParticleMesh as JaxParticleMesh
from qinfer_tpu.parallel.resample import (
    DistributedLiuWestResampler as JaxDistributedLiuWestResampler,
    butterfly_exchange_schedule as jax_schedule,
    shard_systematic_ancestors as jax_ancestors)
from qinfer_tpu.resamplers import counting_locations_from_u as jax_fill

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.parallel import (DistributedLiuWestResampler,
                                       ParticleMesh,
                                       butterfly_exchange_schedule,
                                       shard_systematic_ancestors)
from qinfer_tpu_torch.parallel.resample import shard_generators, two_level_fill
from qinfer_tpu_torch.utils import weighted_moments


class FreeModel(qt.Model):
    """An unconstrained model of ``d`` parameters (every point valid,
    canonicalization the identity)."""

    def __init__(self, d=2):
        super().__init__()
        self._d = d

    @property
    def n_modelparams(self):
        return self._d

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        return torch.ones(modelparams.shape[0], dtype=torch.bool)

    def likelihood(self, outcomes, modelparams, expparams):
        raise NotImplementedError


class PositiveModel(FreeModel):
    def __init__(self):
        super().__init__(1)

    def are_models_valid(self, modelparams):
        return modelparams[:, 0] >= 0


def _mesh(d=8):
    return ParticleMesh(["cpu"] * d)


def _weighted_cloud(seed, n=8192):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, 2), generator=g) * torch.tensor([1.0, 0.5])
         + torch.tensor([2.0, -1.0]))
    w = torch.exp(-0.1 * torch.sum(x ** 2, dim=1))
    return w / w.sum(), x


def _random_masses(rng, D, kind):
    """The adversarial patterns of the JAX test."""
    if kind == 0:
        return rng.dirichlet(np.ones(D))
    if kind == 1:
        return rng.dirichlet(np.ones(D) * 0.05)   # spiky
    if kind == 2:
        m = np.full(D, 1e-9)
        m[rng.integers(D)] = 1.0                   # all mass on one shard
        return m / m.sum()
    if kind == 3:
        m = np.full(D, 1e-9)
        i, j = rng.integers(D, size=2)
        m[i] += 0.5
        m[j] += 0.5
        return m / m.sum()
    return rng.dirichlet(np.ones(D) * 20)          # near-uniform


@pytest.mark.parametrize("D", [4, 8, 16, 32])
def test_ancestors_and_butterfly_schedule_equal_jax(D):
    """Level-1 ancestors and the schedule's shifts and take masks equal
    JAX's; the schedule, replayed with ``np.roll`` for ``ppermute``,
    delivers block A[s] to every shard s in 3·log₂D rounds."""
    rng = np.random.default_rng(D)
    for trial in range(60):
        masses = _random_masses(rng, D, trial % 5).astype(np.float32)
        u = np.float32(rng.uniform())
        want = np.asarray(jax_ancestors(u, jnp.asarray(masses)))
        got = shard_systematic_ancestors(torch.tensor(u),
                                         torch.from_numpy(masses))
        np.testing.assert_array_equal(got.numpy(), want)
        shifts, takes = butterfly_exchange_schedule(got, D)
        j_shifts, j_takes = jax_schedule(jnp.asarray(want), D)
        assert shifts == j_shifts and len(shifts) == 3 * (D.bit_length() - 1)
        np.testing.assert_array_equal(takes.numpy(), np.asarray(j_takes))
        blk = np.arange(D)
        for k, sh in enumerate(shifts):
            blk = np.where(takes[k].numpy(), np.roll(blk, sh), blk)
        np.testing.assert_array_equal(blk, want)


@pytest.mark.parametrize("exchange", ["ring", "butterfly"])
def test_two_level_fill_equals_jax_pieces_to_the_bit(exchange):
    """a = 1: the fill at given u₁ and u₂, from the port and from JAX's
    pieces composed by hand, and the whole resampler's output (h = 0),
    equal to the bit."""
    D, n = 8, 4096
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    # mass on the first shards' blocks, and rough within each block
    w = (np.exp(-((np.arange(n) - 900.0) / 800.0) ** 2)
         * rng.random(n)).astype(np.float32)
    w /= w.sum()
    u1 = np.float32(0.37)
    u2 = rng.uniform(0.0, 0.9, size=D).astype(np.float32)
    mesh = _mesh(D)
    wv, xv = mesh.shard(torch.from_numpy(w)), mesh.shard(torch.from_numpy(x))
    got = two_level_fill(mesh, torch.tensor(u1), torch.from_numpy(u2), wv,
                         xv, exchange)
    wb, xb = w.reshape(D, n // D), x.reshape(D, n // D, 2)
    anc = np.asarray(jax_ancestors(u1, jnp.asarray(wb).sum(axis=1)))
    assert len(set(anc.tolist())) < D  # blocks really move
    # JAX's bit-copying fill ('scan', the twin of its Pallas kernel; its
    # CPU default 'telescope' rounds through a cumsum of differences)
    fill = jax.jit(lambda u, w, x: jax_fill(u, w, x, strategy="scan"))
    want = np.stack([np.asarray(fill(
        jnp.float32(u2[s]), jnp.asarray(wb[anc[s]]), jnp.asarray(xb[anc[s]])))
        for s in range(D)])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))

    # the resampler's draws: u₁ from its generator, then u₂[s], the first
    # draw of shard s's generator (seeded from the state after u₁)
    rs = DistributedLiuWestResampler(mesh, a=1.0, exchange=exchange)
    u1_t, u2_t = rs.fill_inputs(torch.Generator().manual_seed(3),
                                torch.from_numpy(w), torch.from_numpy(x))[:2]
    g = torch.Generator().manual_seed(3)
    assert u1_t == torch.rand((), generator=g)
    assert torch.equal(u2_t, torch.stack([
        torch.rand((), generator=gs)
        for gs in shard_generators(g, mesh, torch.device("cpu"))]))
    new_w, new_x = rs(FreeModel(), torch.Generator().manual_seed(3),
                      torch.from_numpy(w), torch.from_numpy(x))
    fill = two_level_fill(mesh, u1_t, u2_t, wv, xv, exchange)
    assert torch.equal(new_x, mesh.unshard(fill))
    assert torch.equal(new_w, torch.full((n,), 1.0 / n))


@pytest.mark.parametrize("D", [4, 8])
def test_ring_equals_butterfly_bitwise(D):
    n = 4096
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, 2), generator=g)
    w = torch.exp(-2.0 * x[:, 0] ** 2)
    w = w / w.sum()
    outs = {}
    for exchange in ("ring", "butterfly"):
        rs = DistributedLiuWestResampler(_mesh(D), a=0.95, exchange=exchange)
        assert rs.exchange == exchange
        outs[exchange] = rs.call_with_diagnostics(
            FreeModel(), torch.Generator().manual_seed(7), w, x)
    for a, b in zip(outs["ring"], outs["butterfly"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("exchange", ["ring", "butterfly"])
def test_moments_kept_and_weights_uniform(exchange):
    w, x = _weighted_cloud(1, n=16384)
    rs = DistributedLiuWestResampler(_mesh(), a=0.98, exchange=exchange)
    new_w, new_x, n_fb = rs.call_with_diagnostics(
        FreeModel(), torch.Generator().manual_seed(2), w, x)
    mu0, cov0 = weighted_moments(w, x)
    mu1, cov1 = weighted_moments(new_w, new_x)
    np.testing.assert_allclose(mu1.numpy(), mu0.numpy(), atol=0.05)
    np.testing.assert_allclose(cov1.numpy(), cov0.numpy(), rtol=0.3,
                               atol=0.05)
    assert torch.equal(new_w, torch.full((16384,), 1.0 / 16384))
    assert new_x.shape == x.shape and int(n_fb) == 0


def test_concentrated_mass_is_rebalanced():
    """All the mass on shard 0's block: every shard ends near it."""
    n = 8192
    x = torch.cat([torch.full((n // 8, 2), 5.0),
                   torch.randn((n - n // 8, 2),
                               generator=torch.Generator().manual_seed(0))])
    w = torch.cat([torch.ones(n // 8), torch.full((n - n // 8,), 1e-12)])
    w = w / w.sum()
    rs = DistributedLiuWestResampler(_mesh(), a=0.98)
    _, new_x = rs(FreeModel(), torch.Generator().manual_seed(3), w, x)
    near = torch.linalg.norm(new_x - 5.0, dim=1) < 1.0
    assert float(near.float().mean()) > 0.95
    per_shard = new_x.reshape(8, -1, 2).mean(dim=1)
    assert bool(torch.all(torch.abs(per_shard - 5.0) < 1.0))


def test_validity_respected():
    n = 4096
    x = torch.abs(torch.randn((n, 1),
                              generator=torch.Generator().manual_seed(0)))
    x = x * 0.01
    w = torch.full((n,), 1.0 / n)
    rs = DistributedLiuWestResampler(_mesh(), a=0.9, maxiter=10)
    _, new_x, n_fb = rs.call_with_diagnostics(
        PositiveModel(), torch.Generator().manual_seed(1), w, x)
    assert bool(torch.all(new_x[:, 0] >= 0))
    assert int(n_fb) >= 0


@pytest.mark.parametrize("exchange", ["ring", "butterfly"])
def test_full_smc_with_the_distributed_resampler(exchange):
    mesh = _mesh()
    model = qt.SimplePrecessionModel()
    u = qt.SMCUpdater(model, 8192, qt.UniformDistribution([[0.0, 1.0]]),
                      seed=1, sharding=mesh.particle_sharding,
                      resampler=DistributedLiuWestResampler(
                          mesh, a=0.98, exchange=exchange))
    g = torch.Generator().manual_seed(2)
    for k in range(40):
        eps = {"t": torch.tensor([(9 / 8) ** k / 10])}
        u.update(model.simulate_experiment(g, torch.tensor([[0.62]]), eps),
                 eps)
    assert u.resample_count > 0
    std = float(torch.sqrt(u.est_covariance_mtx()[0, 0]))
    assert abs(float(u.est_mean()[0]) - 0.62) < 6 * std + 0.01
    assert u.sharding == mesh.particle_sharding


def test_butterfly_refusals_and_auto():
    mesh6 = _mesh(6)
    with pytest.raises(ValueError, match="power-of-two"):
        DistributedLiuWestResampler(mesh6, exchange="butterfly")
    assert DistributedLiuWestResampler(mesh6, exchange="auto").exchange \
        == "ring"
    # auto takes the butterfly only where it has fewer rounds
    assert DistributedLiuWestResampler(_mesh(8)).exchange == "ring"
    assert DistributedLiuWestResampler(_mesh(32)).exchange == "butterfly"
    assert DistributedLiuWestResampler(_mesh(1)).exchange == "ring"
    with pytest.raises(ValueError, match="axis"):
        DistributedLiuWestResampler(_mesh(8), axis_name="trials")
    with pytest.raises(ValueError, match="exchange"):
        DistributedLiuWestResampler(_mesh(8), exchange="tree")
    with pytest.raises(ValueError, match="power-of-two"):
        butterfly_exchange_schedule(torch.zeros(6, dtype=torch.int64), 6)
    with pytest.raises(ValueError, match="pad_particles"):
        DistributedLiuWestResampler(_mesh(8))(
            FreeModel(), torch.Generator(), torch.full((12,), 1 / 12),
            torch.zeros((12, 2)))


def test_copy_count_law_agrees_with_jax():
    """a = 1 on distinct locations: the copies of each group of 64
    neighbouring particles over 64 seeds, port and JAX (its ``shard_map``
    resampler on the 8 virtual devices), each within 4 Monte-Carlo errors
    (plus one copy, for the counts' discreteness) of n·W_g and of each
    other; every slot holds a source particle."""
    D, n, seeds, group = 8, 4096, 64, 64
    rng = np.random.default_rng(9)
    x = np.stack([np.arange(n, dtype=np.float32),
                  rng.normal(size=n).astype(np.float32)], axis=1)
    # every shard's mass a fraction of a block away from a whole number of
    # blocks, so that every shard's copies vary from seed to seed
    w = (1.0 + 0.9 * np.sin(2 * np.pi * np.arange(n) / n + 0.3)).astype(
        np.float32)
    w /= w.sum()
    expect = n * w.reshape(-1, group).sum(axis=1)

    def group_copies(new_x):
        idx = np.asarray(new_x)[:, 0].astype(np.int64)
        np.testing.assert_array_equal(np.asarray(new_x)[:, 0], idx)
        return np.bincount(idx // group, minlength=n // group)

    mesh = _mesh(D)
    ours = np.stack([group_copies(DistributedLiuWestResampler(mesh, a=1.0)(
        FreeModel(), torch.Generator().manual_seed(s), torch.from_numpy(w),
        torch.from_numpy(x))[1].numpy()) for s in range(seeds)])

    jm = JaxParticleMesh()
    jrs = JaxDistributedLiuWestResampler(jm.mesh, a=1.0)

    class JaxFree(q.Model):
        @property
        def n_modelparams(self):
            return 2

        @property
        def expparams_dtype(self):
            return [("t", "float32")]

        def n_outcomes(self, expparams=None):
            return 2

        def are_models_valid(self, mps):
            return jnp.ones(mps.shape[0], dtype=bool)

        def likelihood(self, outcomes, mps, eps):
            raise NotImplementedError

    jw = jax.device_put(jnp.asarray(w), jm.particle_sharding)
    jx = jax.device_put(jnp.asarray(x), jm.location_sharding)
    call = jax.jit(lambda key: jrs(JaxFree(), key, jw, jx)[1])
    theirs = np.stack([group_copies(call(jax.random.key(s)))
                       for s in range(seeds)])
    for got in (ours, theirs):
        assert np.all(got.sum(axis=1) == n)
        se = got.std(axis=0, ddof=1) / np.sqrt(seeds)
        assert np.all(np.abs(got.mean(axis=0) - expect) <= 4 * se + 1.0)
    se = np.sqrt(ours.var(axis=0, ddof=1) / seeds
                 + theirs.var(axis=0, ddof=1) / seeds)
    assert np.all(np.abs(ours.mean(axis=0) - theirs.mean(axis=0))
                  <= 4 * se + 1.0)
