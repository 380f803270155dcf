"""Data-parallel training in the port (``unidom_torch/parallel``) on the CPU:
two gloo ranks started by ``parallel.launch``, the work they run in
tests/torch_dist_ranks.py.

Port-only invariance (tests/test_sharding.py's, for the port): after one
sharded update the ranks hold the same parameters, those of the serial
recompute (per shard the same noise, nan_to_num, the local clip, then the
mean and Adam), on the cloth (K1's path), whip_rope (K2's) and
shape_elasto_plastic (K3's) arms; ``reset_batch``'s three modes lay out
JAX's global batch; the all-reduced normalizer is the serial update of the
concatenated batch; ``train_para``'s global stiffness draw does not depend
on the ranks; the CLI's ranks write ``metrics.jsonl`` from the lead rank
only; NCCL refuses more ranks than cards, and a failing rank fails the
launch.

Against JAX, once for the slice: one sharded ``minimize`` on 2 ranks and
JAX's ``shard_map`` ``minimize`` on ``make_env_mesh(2)`` from the same
first state, weights and noise (loss, every gradient leaf, the parameters
after Adam, at tests/test_torch_train.py's one-update tolerances), and the
normalizer's all-reduced update against ``update_normalizer(...,
axis_name="env")`` under ``shard_map``.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as R
from jax.sharding import PartitionSpec as P

from unidom_tpu.algorithms.apg import build_apg as jax_build_apg
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth1Env as JaxFoldCloth1Env
from unidom_tpu.models.normalizer import NormalizerParams as JaxNormalizerParams
from unidom_tpu.models.normalizer import update_normalizer as jax_update_normalizer
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh as jax_make_env_mesh
from unidom_torch.algorithms import apg
from unidom_torch.envs import registration
from unidom_torch.models.normalizer import NormalizerParams, update_normalizer
from unidom_torch.ops.gradops import global_norm, global_norm_clip, nan_to_num_tree, tree_flatten
from unidom_torch.parallel import EnvMesh, initialize_distributed, launch, make_env_mesh
from unidom_torch.utils.convert import policy_from_jax

try:
    from jax import shard_map
except ImportError:  # older JAX
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

N_RANKS = 2
ARMS = tuple(R.EP_LEN)
# Ranks and the serial recompute run the same float32 operations on the same
# inputs on the CPU: the parameters agree to rounding (in practice exactly).
TOL_SERIAL = dict(rtol=1e-6, atol=0)
# Against JAX, tests/test_torch_train.py's one-update tolerances: the losses
# agree to 1e-5 relative, every gradient leaf to 1e-3 in relative norm
# (cosine 1 - 1e-6); Adam's first step is +-lr per entry, so the parameters
# are held to JAX's within 1e-3 lr where the gradient is clear of rounding
# (CLEAR_OF_ROUNDING of the leaf's largest entry) and within 2 lr anywhere.
TOL_LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL_NORM = 1e-3
GRAD_COS = 1 - 1e-6
CLEAR_OF_ROUNDING = 1e-2
# The normalizer's moments from equal-sized shards against the concatenated
# batch: the same sums in another order (observations ~3).
TOL_NORM = dict(rtol=1e-6, atol=1e-6)


def _jax_leaves(params):
    """flax params -> the port's parameter order, kernels transposed."""
    out = []
    for i in range(len(params["params"])):
        layer = params["params"][f"dense_{i}"]
        out += [np.asarray(layer["kernel"]).T, np.asarray(layer["bias"])]
    return out


def _jax_noise(key, T, B):
    """The noise JAX's ``minimize`` draws on every shard: ``key, key_grad =
    split(ts.key)``, then per step ``key, key_sample = split(key)``."""
    _, key = jax.random.split(key)
    noise = []
    for _ in range(T):
        key, key_sample = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(key_sample, (B, 6))))
    return np.stack(noise)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's sharded cloth update on a 2-device mesh and the inputs the
    port's ranks get from it, and the normalizer's inputs."""
    B, T = R.B_LOCAL["cloth"], R.EP_LEN["cloth"]
    jenv = JaxFoldCloth1Env(B, conf=JaxClothConf(mem_saving_level=1, **R.CLOTH))
    mesh = jax_make_env_mesh(N_RANKS)
    init_ts, jmin, reset_batch, _ = jax_build_apg(jenv, T, R.LR, R.MAX_NORM, mesh=mesh)
    jts = init_ts(0)
    key = jax.random.PRNGKey(R.RESET_SEED)
    jstate = jax.device_get(reset_batch(key))
    # reset_batch splits its key over the devices; each device's reset draws
    # its cloth's shift from the first half of its own key
    shifts = [np.asarray(jax.random.normal(jax.random.split(k)[0], (2,)) * 0.05)
              for k in jax.random.split(key, N_RANKS)]
    noise = _jax_noise(jts.key, T, B)
    weights = policy_from_jax(jax.device_get(jts.policy_params), device="cpu").state_dict()
    rng = np.random.default_rng(5)
    norm_params = (np.float32(6.0), rng.standard_normal(8).astype(np.float32),
                   (rng.random(8) * 4).astype(np.float32))
    norm_obs = (rng.standard_normal((N_RANKS, 3, 5, 8)) * 3 + 1).astype(np.float32)
    norm_obs[1] += 2.0  # the ranks' batches differ in mean: the between-rank term counts
    return dict(jenv=jenv, jts=jts, jmin=jmin, jstate=jstate, shifts=shifts, noise=noise,
                weights=weights, norm=(norm_params, norm_obs))


def _expected_states(arm):
    """The two shards' first states as JAX lays out the global batch, made
    here: cloth (``reset``) from one seed per rank drawn from the
    generator, rank r resetting from its own (JAX splits its key over the
    devices); whip_rope (``auto_reset``) the halves of an env of all the
    envs (one draw per global env); shape_elasto_plastic (``host_reset``)
    one local reset on both (JAX tiles it)."""
    gen = torch.Generator().manual_seed(R.RESET_SEED)
    if arm == "cloth":
        env = R.make_arm_env(arm, R.B_LOCAL[arm])
        assert env.reset_mode == "reset"
        seeds = torch.randint(2**62, (N_RANKS,), generator=gen)
        return [env.reset(torch.Generator().manual_seed(int(seed)))[1] for seed in seeds]
    if arm == "whip_rope":
        b = R.B_LOCAL[arm]
        genv = R.make_arm_env(arm, N_RANKS * b)
        assert genv.reset_mode == "auto_reset"
        state = genv.auto_reset(genv.init_state, gen)
        leaves, rebuild = tree_flatten(state)
        return [rebuild([t[r * b:(r + 1) * b] for t in leaves]) for r in range(N_RANKS)]
    env = R.make_arm_env(arm, R.B_LOCAL[arm])
    assert env.reset_mode == "host_reset"
    return [env.reset(gen)[1]] * N_RANKS


def _jax_update(j):
    """JAX's ``shard_map`` ``minimize`` on the 2-device mesh from the ranks'
    inputs, and each shard's loss and raw gradient (``minimize.debug``'s
    ``loss_grad``, one compile for both shards)."""
    jts, jmin, jstate = j["jts"], j["jmin"], j["jstate"]
    B = R.B_LOCAL["cloth"]
    new_jts, jmetrics = jmin(jts, jax.device_put(jstate))
    _, key_grad = jax.random.split(jts.key)
    loss_grad = jax.jit(jmin.debug["loss_grad"])
    shards = []
    for r in range(N_RANKS):
        shard = jax.tree_util.tree_map(lambda x: x[r * B:(r + 1) * B], jstate)
        jgrad, (jrewards, _, _) = loss_grad(jts.policy_params, jts.normalizer_params, shard,
                                            key_grad)
        shards.append(dict(x=np.asarray(shard.x), loss=-float(np.mean(np.asarray(jrewards))),
                           grad=jgrad))
    return dict(params=_jax_leaves(jax.device_get(new_jts.policy_params)),
                reward=float(jmetrics["reward"]), shards=shards)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results of ``torch_dist_ranks.rank_jobs`` (one launch),
    and what this process computes while the ranks run: each arm's expected
    shards and serial update, JAX's sharded update, and ``train_para`` on
    one rank."""
    j = jax_side
    logdir = str(tmp_path_factory.mktemp("para2"))
    logdir1 = str(tmp_path_factory.mktemp("para1"))
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(
            launch, R.rank_jobs, N_RANKS, "cpu",
            args=((j["shifts"], j["weights"], j["noise"]), j["norm"], logdir))
        here = {"states": {arm: _expected_states(arm) for arm in ARMS}}
        here["serial"] = {arm: _serial_update(arm, here["states"][arm]) for arm in ARMS}
        here["jax"] = _jax_update(j)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(registration.env_functions, "fold_cloth1_para", R.tiny_para)
            here["para"] = R.recorded_train_para(N_RANKS * R.B_LOCAL["cloth"], logdir1)
        here["para_logdir"] = logdir1
        out = ranks_run.result()
    return out, logdir, here


def _serial_update(arm, states):
    """The update recomputed in this process: each shard's gradient from the
    same weights and noise (the generator restarted per shard), nan_to_num,
    the global-norm clip, then the mean over the shards and one Adam step.
    Returns (parameters after it, the mean gradient, parameters before)."""
    env = R.make_arm_env(arm, R.B_LOCAL[arm])
    init_ts, minimize, _, _ = R.build(arm, env)
    ts = init_ts(R.SEED)
    noise_state = ts.generator.get_state()
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    grads, seen = [], []
    for state in states:
        same = [g for s, g in seen if _state_equal(s, state)]
        if same:  # the same shard gives the same gradient
            grads.append(same[0])
            continue
        ts.generator.set_state(noise_state)
        _, g, _ = minimize.debug["loss_grad"](ts, state)
        grads.append(global_norm_clip(nan_to_num_tree(g), R.MAX_NORM))
        seen.append((state, grads[-1]))
    mean = [sum(gs) / len(gs) for gs in zip(*grads)]
    for p, g in zip(ts.policy.parameters(), mean):
        p.grad = g
    ts.optimizer.step()
    return [p.detach() for p in ts.policy.parameters()], mean, params0


def _leaves(state):
    return tree_flatten(state)[0]


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("arm", ARMS)
def test_sharded_update_matches_the_serial_recompute(ranks, arm):
    out, _, here = ranks
    r0, r1 = (o[arm] for o in out)
    for p, q in zip(r0["params"], r1["params"]):
        assert torch.equal(p, q)
    assert r0["metrics"]["reward"] == r1["metrics"]["reward"]
    for r in (r0, r1):  # grad_norm is the rank's own raw norm
        assert float(r["metrics"]["grad_norm"]) == pytest.approx(float(global_norm(r["grad"])))
        assert float(r["metrics"]["grad_norm"]) > 0
    want, mean, params0 = here["serial"][arm]  # from the shards of _expected_states
    for p, w in zip(r0["params"], want):
        torch.testing.assert_close(p, w, **TOL_SERIAL)
    assert float(global_norm(mean)) > 0
    assert any(not torch.equal(p, q) for p, q in zip(r0["params"], params0))
    if R.NORMALIZE[arm]:
        n0, n1 = r0["normalizer"], r1["normalizer"]
        assert float(n0.count) == N_RANKS * R.B_LOCAL[arm] * (1 + R.EP_LEN[arm])
        assert torch.equal(n0.mean, n1.mean) and torch.equal(n0.m2, n1.m2)


@pytest.mark.parametrize("arm", ARMS, ids=[f"{a}-{m}" for a, m in zip(
    ARMS, ("reset", "auto_reset", "host_reset"))])
def test_reset_batch_lays_out_jax_global_batch(ranks, arm):
    out, _, here = ranks
    s0, s1 = (o[arm]["state"] for o in out)
    for got, want in zip((s0, s1), here["states"][arm]):
        assert _state_equal(got, want)
    if arm == "cloth":
        assert not torch.equal(s0.x, s1.x)  # each rank its own shift
    elif arm == "whip_rope":
        assert not torch.equal(s0.primitives[0].position, s1.primitives[0].position)


def test_normalizer_all_reduce_is_the_serial_update_of_the_whole_batch(ranks, jax_side):
    out, _, _ = ranks
    (count, mean, m2), obs = jax_side["norm"]
    n0, n1 = (o["normalizer"] for o in out)
    assert torch.equal(n0.mean, n1.mean) and torch.equal(n0.m2, n1.m2)
    serial = update_normalizer(
        NormalizerParams(torch.tensor(count), torch.from_numpy(mean), torch.from_numpy(m2)),
        torch.from_numpy(np.concatenate(list(obs))))
    assert float(n0.count) == float(serial.count) == count + obs.size // obs.shape[-1]
    np.testing.assert_allclose(n0.mean.numpy(), serial.mean.numpy(), **TOL_NORM)
    np.testing.assert_allclose(n0.m2.numpy(), serial.m2.numpy(), **TOL_NORM)
    # the between-rank variance is in it: each rank's own moments miss it
    local = update_normalizer(
        NormalizerParams(torch.tensor(count), torch.from_numpy(mean), torch.from_numpy(m2)),
        torch.from_numpy(obs[0]))
    assert (n0.m2 - local.m2).abs().max() > 1.0


def test_normalizer_matches_jax_shard_map(ranks, jax_side):
    out, _, _ = ranks
    (count, mean, m2), obs = jax_side["norm"]
    mesh = jax_make_env_mesh(N_RANKS)
    fn = shard_map(lambda p, o: jax_update_normalizer(p, o, axis_name="env"), mesh=mesh,
                   in_specs=(P(), P("env")), out_specs=P(), check_vma=False)
    params = JaxNormalizerParams(jnp.asarray(count), jnp.asarray(mean), jnp.asarray(m2))
    jn = jax.jit(fn)(params, jnp.asarray(obs.reshape((-1,) + obs.shape[2:])))
    n = out[0]["normalizer"]
    assert float(n.count) == float(jn.count)
    np.testing.assert_allclose(n.mean.numpy(), np.asarray(jn.mean), **TOL_NORM)
    np.testing.assert_allclose(n.m2.numpy(), np.asarray(jn.m2), rtol=1e-5, atol=1e-5)


def test_sharded_minimize_matches_jax_shard_map(ranks):
    out, _, here = ranks
    ref = here["jax"]
    jclipped = []
    clip = jax.jit(lambda g: jax_global_norm_clip(jax_nan_to_num_tree(g), R.MAX_NORM))
    for o, shard in zip(out, ref["shards"]):
        got = o["jax_inputs"]
        np.testing.assert_allclose(got["x"].numpy(), shard["x"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(got["loss"]), shard["loss"], **TOL_LOSS)
        for g, r in zip(got["grad"], _jax_leaves(shard["grad"])):
            g = g.numpy()
            assert np.linalg.norm(g - r) <= GRAD_REL_NORM * np.linalg.norm(r)
            cos = float((g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)))
            assert cos >= GRAD_COS
        jclipped.append(clip(shard["grad"]))
    np.testing.assert_allclose(out[0]["jax_inputs"]["metrics"]["reward"], ref["reward"],
                               rtol=1e-5)
    # JAX's pmean of the clipped gradients, for which entries are clear of rounding
    jmean = jax.tree_util.tree_map(lambda *gs: sum(gs) / len(gs), *jclipped)
    for p, q, r, g in zip(out[0]["jax_inputs"]["params"], out[1]["jax_inputs"]["params"],
                          ref["params"], _jax_leaves(jmean)):
        assert torch.equal(p, q)
        p = p.numpy()
        clear = np.abs(g) > CLEAR_OF_ROUNDING * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-3 * R.LR)
        assert np.abs(p - r).max() <= 2 * R.LR * (1 + 1e-3)


def test_train_para_global_stiffness_is_the_same_at_one_and_two_ranks(ranks):
    out, logdir, here = ranks
    seen1, history1, _ = here["para"]
    (seen_a, history_a, params_a), (seen_b, _, params_b) = (o["para"] for o in out)
    assert len(seen1) == len(seen_a) == 2  # one draw per iteration
    for one, a, b in zip(seen1, seen_a, seen_b):
        assert torch.equal(torch.cat([a, b]), one)
    assert not torch.equal(seen1[0], seen1[1])
    for p, q in zip(params_a, params_b):
        assert torch.equal(p, q)
    assert [h["it"] for h in history_a] == [h["it"] for h in history1] == [0, 1]
    one = (Path(here["para_logdir"]) / "metrics.jsonl").read_text().splitlines()
    assert len(one) == 1  # the one sweep
    lead = (Path(logdir) / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["it"] for line in lead] == [0]  # written by the lead rank alone


def test_cli_devices_writes_metrics_from_the_lead_rank_only(tmp_path, monkeypatch):
    """``--device cpu --devices 2`` starts two ranks of ``train`` here; the
    file holds each iteration once."""
    monkeypatch.setattr(apg, "_train_rank", R.tiny_train_rank)
    apg.main(["--env", "fold_cloth1", "--ep_len", "1", "--num_envs", "2", "--max_it", "1",
              "--num_eval_envs", "1", "--eval_freq", "2", "--device", "cpu", "--devices", "2",
              "--logdir", str(tmp_path)])
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["it"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["train_reward"]) and r["grad_norm"] > 0 for r in recs)
    for it in ("0", "best"):
        assert (tmp_path / f"apg_fold_cloth1_{it}.pt").exists()


def test_backends_and_meshes_refuse_what_they_cannot_run():
    """NCCL with more ranks than visible cards raises (no fall-back), as
    does a mesh of several devices without a process group; one process
    without a coordinator joins nothing."""
    with pytest.raises(ValueError, match="card per rank"):
        launch(R.tiny_train_rank, torch.cuda.device_count() + 1, "cuda", "nccl")
    with pytest.raises(ValueError, match="gloo"):
        launch(R.tiny_train_rank, 2, "cpu", "nccl")
    with pytest.raises(ValueError, match="no process group"):
        make_env_mesh(2, "cpu")
    initialize_distributed(None, 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    assert make_env_mesh(1, "cpu") == EnvMesh(1, 0, torch.device("cpu"))


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(R.fail_on_rank_1, 2, "cpu")
