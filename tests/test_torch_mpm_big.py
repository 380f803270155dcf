"""The port's big-grid MPM step on the CPU: the plain macro step (K3-fwd's
plain version) against ``unidom_tpu``'s XLA oracle on a pour_soup-class
configuration (water and elastic particles under two bowls) and a
sigma-clip one, and against the JAX package's big-grid Pallas kernel (K3,
interpret mode) where its windows cover; ``kernel_route`` between K2 and K3;
the K3 wrapper's sizes and refusals, and where it sends a gradient request
on a CUDA tensor; and the build's hash over the headers a source includes. Inputs are made
with numpy from a seed and fed to both sides."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.engine import mpm as jmpm
from unidom_tpu.engine import primitives as jprim
from unidom_torch.engine.mpm import (
    ELASTIC,
    PLASTIC_CLIP,
    WATER,
    MPMConf,
    MPMSimulator,
    kernel_route,
)
from unidom_torch.engine.primitives import create_primitive
from unidom_torch.envs.mpm_tasks import PourSoupConf, ShapeElastoPlasticConf, WhipRopeConf
from unidom_torch.ops.cuda import _build
from unidom_torch.ops.cuda.mpm_big_kernel import (
    bin_scratch,
    bwd_scratch,
    check_supported_big,
    list_capacity,
    mpm_big_step,
    record_bytes,
    scratch_bytes,
)
from unidom_torch.ops.cuda.mpm_kernel import MAX_CELLS, MAX_PARTICLES, mpm_step
from unidom_torch.utils.convert import mpm_state_from_jax

torch.set_num_threads(1)

B = 2


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------- configurations

def _mixture(sim, make_primitive):
    """tests/test_pallas_mpm_big.py's pour_soup-class scene: water and an
    elastic bar at hardness 0.3 between two bowls."""
    state = sim.add_box(None, size=[0.2, 0.2, 0.2], init_pos=[0.4, 0.2, 0.25], material=WATER,
                        density=2.0)
    state = sim.add_box(state, size=[0.1, 0.05, 0.05], init_pos=[0.5, 0.05, 0.25],
                        material=ELASTIC, density=2.0, hardness=0.3)
    for init_pos in ([0.4, 0.2, 0.25], [0.5, 0.06, 0.2]):
        state.primitives.append(make_primitive(4, friction=0.1, softness=666.0, color=[0.5] * 3,
                                               size=[0.09, 0.0, 0.008], init_pos=init_pos))
        sim.register_primitive_sdf("container")
    return state


def _slab(sim, make_primitive, material=PLASTIC_CLIP, density=1.5):
    """tests/test_pallas_mpm_big.py's build_pair scene: a bar pushed by a box."""
    state = sim.add_box(None, size=[0.25, 0.06, 0.06], init_pos=[0.5, 0.08, 0.5],
                        material=material, density=density)
    state.primitives.append(make_primitive(4, friction=0.2, softness=666.0, color=[0.5] * 3,
                                           size=[0.03, 0.03, 0.03], init_pos=[0.5, 0.06, 0.46]))
    sim.register_primitive_sdf("box")
    return state


CONFIGS = {
    # name: (MPMConf kwargs, scene, position control)
    "mixture_bowls": (dict(n_grid=32, dt=4e-4, steps=4, E=5e-5, nu=0.4999, res=(24, 12, 16),
                           ground_friction=0.1), _mixture, False),
    "sigma_clip": (dict(n_grid=32, dt=2e-4, steps=4, E=100.0, nu=0.1, res=(16, 16, 16),
                        ground_friction=0.5), _slab, False),
    "elastic_pc": (dict(n_grid=32, dt=2e-4, steps=4, E=100.0, nu=0.1, res=(16, 16, 16),
                        ground_friction=0.5),
                   lambda sim, mk: _slab(sim, mk, material=ELASTIC), True),
}


def _action(n_prim):
    a = np.zeros((B, 6 * n_prim), np.float32)
    a[:, :6] = [[0.3, 0.0, 0.1, 0.0, 0.0, 0.05], [0.2, 0.0, -0.1, 0.05, 0.0, 0.0]]
    return a


def _perturb(state, rng, n_particles):
    """Random v about a drift (the grid transfers average the noise away),
    per-particle mu and a small yield stress, the same on both sides."""
    v = (0.1 * rng.standard_normal((B, n_particles, 3)) + [0.3, 0.0, -0.2]).astype(np.float32)
    mu_scale = (1.0 + 0.5 * rng.random((B, n_particles))).astype(np.float32)
    return v, mu_scale


@pytest.fixture(scope="module", params=list(CONFIGS))
def refs(request):
    """JAX's macro step for one configuration from a perturbed reset state:
    the XLA oracle's and the big-grid Pallas kernel's in interpret mode (its
    windows cover these scenes)."""
    kwargs, scene, pc = CONFIGS[request.param]
    out, state = {}, None
    for backend in ("xla", "pallas_big"):
        conf = jmpm.MPMConf(**kwargs, backend=backend, task="t", goal_path="")
        sim = jmpm.MPMSimulator(conf, batch_size=B, use_position_control=pc)
        s0 = sim.reset(scene(sim, jprim.create_primitive))
        assert sim.backend == backend
        if state is None:
            v, mu_scale = _perturb(s0, np.random.default_rng(0), sim.n_particles)
            state = s0._replace(v=jnp.asarray(v), mu=s0.mu * jnp.asarray(mu_scale),
                                yield_stress=jnp.full_like(s0.yield_stress, 0.05))
        n_prim = len(state.primitives)
        out[backend] = jax.device_get(sim.step_batch(state, jnp.asarray(_action(n_prim)))[0])
    return request.param, jax.device_get(state), out


def _torch_sim(name):
    """(simulator, its reset state) for one configuration, on the CPU."""
    kwargs, scene, pc = CONFIGS[name]
    sim = MPMSimulator(MPMConf(**kwargs, task="t"), B, use_position_control=pc, device="cpu")
    state = sim.reset(scene(sim, lambda *a, **k: create_primitive(*a, **k, device="cpu")))
    return sim, state


# tests/test_pallas_mpm_big.py's tolerances between the JAX oracle and its
# big-grid kernel: float32 sums in another order over 4 substeps.
STEP_TOL = {"x": (1e-4, 1e-5), "v": (1e-3, 1e-4), "C": (1e-3, 1e-2), "F": (1e-3, 1e-4),
            "J": (1e-3, 1e-5)}


@pytest.mark.parametrize("reference", ["xla", "pallas_big"])
def test_plain_step_matches_jax(refs, reference):
    name, jstate, out = refs
    sim, _ = _torch_sim(name)
    assert sim.n_particles == jstate.x.shape[1]
    state = mpm_state_from_jax(jstate, device="cpu")
    n_prim = len(state.primitives)
    before = mpm_big_step.launches
    got = mpm_big_step(sim, state, torch.from_numpy(_action(n_prim)))
    assert mpm_big_step.launches == before  # the plain step, on the CPU
    ref = out[reference]
    for field, (rtol, atol) in STEP_TOL.items():
        np.testing.assert_allclose(getattr(got, field).numpy(), _np(getattr(ref, field)),
                                   rtol=rtol, atol=atol, err_msg=field)
    for i in range(n_prim):
        for field in ("position", "rotation"):
            np.testing.assert_allclose(getattr(got.primitives[i], field).numpy(),
                                       _np(getattr(ref.primitives[i], field)), atol=1e-6)
    assert np.abs(_np(ref.x) - _np(jstate.x)).max() > 1e-4  # the step moved the particles


def test_mixture_scene_is_what_pour_soup_mixes():
    sim, _ = _torch_sim("mixture_bowls")
    assert set(sim.material.tolist()) == {WATER, ELASTIC}
    assert sim.sdf_names == ["container", "container"]
    assert sorted(set(sim.h.tolist())) == [pytest.approx(0.3), 1.0]


# ---------------------------------------------------------------- routing

def _sim_of(conf, n_particles, sdf_names):
    sim = MPMSimulator(conf, 2, device="cpu")
    sim.n_particles, sim.sdf_names = n_particles, list(sdf_names)
    return sim


def test_kernel_route():
    assert kernel_route(_sim_of(WhipRopeConf, 67, ["box"])) == "k2"
    assert kernel_route(_sim_of(PourSoupConf, 7694, ["container"] * 2)) == "k3"
    assert kernel_route(_sim_of(ShapeElastoPlasticConf, 23940, ["box"])) == "k3"
    # more particles than K2 holds on a grid it does take: K3
    small_grid = dataclasses.replace(WhipRopeConf, res=(48, 32, 48))
    assert small_grid.res[0] * small_grid.res[1] * small_grid.res[2] <= MAX_CELLS
    assert kernel_route(_sim_of(small_grid, MAX_PARTICLES + 1, ["box"])) == "k3"
    with pytest.raises(NotImplementedError, match="at most 4 primitives"):
        kernel_route(_sim_of(PourSoupConf, 7694, ["container"] * 5))
    assert kernel_route(_sim_of(PourSoupConf, 7694, ["torus"])) == "k3"
    with pytest.raises(NotImplementedError, match="SDFs"):
        kernel_route(_sim_of(PourSoupConf, 7694, ["ellipsoid"]))


def test_big_kernel_sizes():
    sim = _sim_of(PourSoupConf, 7694, ["container"] * 2)
    assert list_capacity(sim) == 27 * 7694  # fewer than the 1,048,576 cells
    per_env = scratch_bytes(sim, 1)
    # the float4 grid and marks, 20 MB; a rollout's P2G sums in float, 16 MB;
    # the sort by bin, 4.6 MB
    assert 40 * 2**20 < per_env < 44 * 2**20
    assert scratch_bytes(sim, 64) == 64 * per_env
    with pytest.raises(NotImplementedError, match="65535 envs"):
        check_supported_big(sim, 65536)


@pytest.mark.parametrize("name, conf, P, sdfs, n_envs, K, record_mb", [
    ("pour_soup", PourSoupConf, 7694, ["container"] * 2, 3, 4, 50.23),
    ("shape_elasto_plastic", ShapeElastoPlasticConf, 23940, ["box"], 3, 4, 18.84),
    # the stride rule's K at the widths the card trains: the record of a
    # segment's grids, list_cap (4 + 16 B) per slot and 4 B per particle
    ("shape_elasto_plastic", ShapeElastoPlasticConf, 23940, ["box"], 16, 4, 100.5),
    ("pour_soup", PourSoupConf, 7694, ["container"] * 2, 32, 5, 669.7),
])
def test_big_scratch_counts_the_sort_in_a_rollout(name, conf, P, sdfs, n_envs, K, record_mb):
    """A rollout sorts by bin as a gradient's forward does: its scratch
    counts the sort's ints (each bin's counter, the bin list, each
    particle's bin, rank and slot) and P2G's float sums (16 B per cell); a
    gradient's counts the double sums (32 B per cell) instead of the float
    ones, K3-seg's record of K substeps' grids for K3-bwd (per slot the
    touched list's capacity at 20 B, cell and momentum and mass, and the
    particles' bin order at 4 B) and, for K > 1, the float scratch that
    K3-seg sums in, which the simulator keeps between calls."""
    sim = _sim_of(conf, P, sdfs)
    rx, ry, rz = conf.res
    cells = rx * ry * rz
    n_ints, n_keys, bin_cap = bin_scratch(sim)
    assert n_keys == (rx + 2) * (ry + 2) * (rz + 2) + 1 and bin_cap == min(P, n_keys)
    assert n_ints == n_keys + 1 + bin_cap + 3 * P
    rollout = scratch_bytes(sim, 1)
    base = (20 * cells + 4 * list_capacity(sim) + 4 + 8 * 25 * P
            + 4 * (conf.steps + 1) * len(sdfs) * 14)
    assert rollout == base + 4 * n_ints + 16 * cells
    floats, doubles = bwd_scratch(sim)
    assert floats == 4 * cells + 25 * P + 4 * 7  # the record holds each cell before the grid ops
    record = K * (20 * list_capacity(sim) + 4 + 4 * P)
    assert record_bytes(sim, K) == record
    assert n_envs * record / 1e6 == pytest.approx(record_mb, abs=0.05)
    assert scratch_bytes(sim, n_envs, K) == n_envs * (
        base + 4 * n_ints + 32 * cells + 4 * -(-conf.steps // K) * 25 * P + 8 * 25 * P
        + 4 * floats + 8 * doubles + 4 + record + 4 * K * 25 * P
        # K > 1: K3-seg's float sums, marks and sort, kept between calls
        + (20 * cells + 4 * n_ints if K > 1 else 0))


def test_rollout_keeps_its_zeroed_scratch_per_simulator():
    """A rollout's float sums, marks and sort counters are zeroed once per
    simulator, batch size, device and stream and kept (K3-fwd leaves them at
    0), one set per simulator, dropped with it; a rollout takes no gacc or
    mark of the caller's."""
    import gc

    from unidom_torch.ops.cuda import mpm_big_kernel as mbk

    conf = MPMConf(**{**CONFIGS["sigma_clip"][0], "task": "t"})
    sim = _sim_of(conf, 78, ["box"])
    cpu = torch.device("cpu")
    first = mbk._rollout_scratch(sim, 2, cpu, (2, cpu, None))
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    n_ints, n_keys, _ = bin_scratch(sim)
    assert [tuple(t.shape) for t in first] == [(2, cells, 4), (2, cells), (2 * n_ints,)]
    assert all(not t.any() for t in first)
    assert all(a is b for a, b in zip(mbk._rollout_scratch(sim, 2, cpu, (2, cpu, None)), first))
    counters = mbk.zeroed_parts(sim, first)
    assert counters[2].shape == (2 * (n_keys + 1),)
    other = mbk._rollout_scratch(sim, 3, cpu, (3, cpu, None))
    assert other[0].shape[0] == 3 and mbk._ROLLOUT_SCRATCH[sim][0] == (3, cpu, None)
    assert len([k for k in mbk._ROLLOUT_SCRATCH.keys() if k is sim]) == 1
    with pytest.raises(ValueError, match="takes no gacc or mark"):
        mbk._call_big(sim, None, None, None, what=0, mark=torch.zeros(2, cells))
    n_kept = len(mbk._ROLLOUT_SCRATCH)
    del sim
    gc.collect()
    assert len(mbk._ROLLOUT_SCRATCH) == n_kept - 1


def test_cpu_step_launches_no_kernel_and_gradient_on_cuda_reaches_k3_bwd(monkeypatch):
    """On the CPU K3's wrapper runs the plain step (autograd differentiates
    it); on a CUDA tensor a gradient request goes to the differentiable
    kernel step (K3-fwd with checkpoints, K3-bwd in the backward) at the
    stride rule's K, and a rollout to K3-fwd alone (a stand-in state reports
    a CUDA device; recorders stand in for the kernel steps)."""
    from unidom_torch.ops.cuda import mpm_big_kernel as mbk

    sim, state = _torch_sim("sigma_clip")
    before = (mpm_big_step.launches, mpm_big_step.bwd_launches, mpm_big_step.cuda_launches,
              mpm_step.launches)
    v = state.v.clone().requires_grad_()
    out = mpm_big_step(sim, state.replace(v=v), torch.from_numpy(_action(1)))
    out.x.sum().backward()
    assert (mpm_big_step.launches, mpm_big_step.bwd_launches, mpm_big_step.cuda_launches,
            mpm_step.launches) == before
    assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0

    big = _sim_of(PourSoupConf, 4, ["container"] * 2)
    prepared = object()
    monkeypatch.setattr(big, "prepare", lambda s, a: prepared)
    calls = []
    monkeypatch.setattr(mbk, "kernel_step_big", lambda *a: calls.append(("bwd",) + a) or "step")
    monkeypatch.setattr(mbk, "launch_big", lambda *a: calls.append(("fwd",) + a) or "rollout")
    cuda_state = types.SimpleNamespace(x=types.SimpleNamespace(device=torch.device("cuda", 0),
                                                               shape=(2, 4, 3)))
    action = torch.zeros(2, 12, requires_grad=True)
    assert mpm_big_step(big, cuda_state, action) == "step"
    assert mpm_big_step(big, cuda_state, action, ckpt_stride=5) == "step"
    with torch.no_grad():
        assert mpm_big_step(big, cuda_state, action) == "rollout"  # a rollout asks for no gradient
    assert calls == [("bwd", big, prepared, None), ("bwd", big, prepared, 5),
                     ("fwd", big, prepared)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mpm_big_step(sim, state.replace(x=state.x.to("meta")), torch.from_numpy(_action(1)))
    assert (mpm_big_step.launches, mpm_big_step.bwd_launches, mpm_big_step.cuda_launches) == \
        before[:3]


# ---------------------------------------------------------------- the build

def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A change to a header that a source includes alone gives the source
    another library, so a stale build is never loaded."""
    (tmp_path / "dev.cuh").write_text("#pragma once\n#include \"inner.cuh\"\n")
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text("#include \"dev.cuh\"\n#include <math.h>\nint f() { return 1; }\n")
    (tmp_path / "other.cu").write_text("int g() { return 2; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._sources("k.cu") == ["k.cu", "dev.cuh", "inner.cuh"]
    k1, other1 = _build.library_path("k.cu"), _build.library_path("other.cu")
    (tmp_path / "inner.cuh").write_text("// v2\n")
    k2 = _build.library_path("k.cu")
    assert k2 != k1 and k2.name.startswith("k-")
    assert _build.library_path("other.cu") == other1
    (tmp_path / "inner.cuh").write_text("// v1\n")
    assert _build.library_path("k.cu") == k1


def test_both_mpm_sources_include_the_shared_header():
    assert _build._sources("mpm_step.cu") == ["mpm_step.cu", "mpm_device.cuh"]
    assert _build._sources("mpm_big_step.cu") == ["mpm_big_step.cu", "mpm_device.cuh"]
    # K3-fwd rounds each multiply and add apart, as the plain step does
    assert "-fmad=false" in _build._flags("mpm_big_step.cu")
    assert "-fmad=false" not in _build._flags("mpm_step.cu")
