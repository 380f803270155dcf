"""Gradient-based trajectory optimisation through the differentiable
simulator: batched shooting of open-loop action sequences, a policy network
optimised through the simulator, and the expert-data factory.

Counterpart of ``unidom_tpu/algorithms/solver.py``. ``TrajectorySolver``:
the action sequence is a (B, H, A) tensor, B independent problems solved at
once, optimised with Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8)
through autograd of H ``env.step_diff`` calls. Each update takes the
rollout's loss (minus the mean over envs of the summed rewards), its
gradient with ``nan_to_num``, Adam's step and a clamp to the action bounds.
On the card every macro step's gradient goes through the simulator's
backward kernels. (The JAX solver's momentum optimiser and custom loss have
no caller and are not ported.)

``SolverNN`` optimises a ``PolicyMLP`` (``tanh`` on its output, no
observation normaliser) by the same rollout loss, each action the policy's
of the current observation. ``generate_experts`` draws material parameters
per env into the state, solves each instance with ``TrajectorySolver`` and
pickles the best actions, rewards, parameters and point clouds as JAX's
``expert_{inst:04d}.pkl`` records.
"""

import os
import pickle

import numpy as np
import torch

from unidom_torch.models.mlp import PolicyMLP


class TrajectorySolver:
    """Optimise an open-loop action sequence through ``env.step_diff``."""

    def __init__(self, env, horizon: int, lr: float = 0.02, action_bounds=(-1.0, 1.0)):
        self.env = env
        self.horizon = horizon
        self.lr = lr
        self.bounds = action_bounds

    def make_optimizer(self, actions):
        """Adam over the leaf tensor ``actions``."""
        return torch.optim.Adam([actions], lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def rollout_loss(self, actions, state):
        """(loss, rewards (H, B), final state) of the H macro steps of
        ``actions`` (B, H, A) from ``state``."""
        rewards = []
        for t in range(self.horizon):
            _, reward, _, info = self.env.step_diff(actions[:, t], state)
            state = info["state"]
            rewards.append(reward)
        rewards = torch.stack(rewards)
        return -rewards.sum(0).mean(), rewards, state

    def step(self, actions, optimizer, state):
        """One update of the leaf ``actions`` (B, H, A), in place: the
        rollout's loss, its gradient (``nan_to_num``), Adam's step and the
        clamp to the bounds. Returns (rewards (H, B) of the actions
        before the update, the final state, the gradient)."""
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, rewards, final = self.rollout_loss(actions, state)
            loss.backward()
        actions.grad = torch.nan_to_num(actions.grad)
        optimizer.step()
        with torch.no_grad():
            actions.clamp_(self.bounds[0], self.bounds[1])
        return rewards.detach(), final, actions.grad.detach().clone()

    def init_actions(self, generator=None, scale=0.01):
        """N(0, scale^2) actions (B, H, A) from ``generator`` (a CPU
        generator; seed 0 by default), on the env's device."""
        generator = generator or torch.Generator().manual_seed(0)
        shape = (self.env.batch_size, self.horizon, self.env.action_size)
        return (torch.randn(shape, generator=generator) * scale).to(self.env.device)

    def solve(self, state, generator=None, n_iters: int = 50, actions=None, verbose=False):
        """Returns (best actions, best total reward per env, the mean total
        reward of each iteration). An env's best actions are those an update
        produced in the iteration whose total reward beat its best so far
        (strictly), as the JAX solver keeps them."""
        if actions is None:
            actions = self.init_actions(generator)
        actions = actions.detach().clone().requires_grad_()
        optimizer = self.make_optimizer(actions)
        best_actions = actions.detach().clone()
        best_reward = torch.full((self.env.batch_size,), -torch.inf, device=actions.device)
        history = []
        for it in range(n_iters):
            rewards, _, _ = self.step(actions, optimizer, state)
            total = rewards.sum(0)
            improved = total > best_reward
            best_reward = torch.where(improved, total, best_reward)
            best_actions = torch.where(improved[:, None, None], actions.detach(), best_actions)
            history.append(float(total.mean()))
            if verbose and it % 10 == 0:
                print(f"  solver it {it}: reward {history[-1]:.4f}")
        return best_actions, best_reward, history


class SolverNN:
    """Optimise a policy network through the simulator: an MLP from the
    observation to ``tanh`` of the action, by Adam (optax's defaults) on
    the gradient (``nan_to_num``) of minus the mean over envs of the summed
    rewards of ``horizon`` macro steps. The weights start as ``PolicyMLP``'s
    from ``generator``; ``convert.copy_policy_from_jax`` carries JAX's
    over."""

    def __init__(self, env, horizon, lr=1e-3, hidden=(256, 256), generator=None, device=None):
        self.env = env
        self.horizon = horizon
        self.policy = PolicyMLP(env.observation_size, env.action_size, hidden,
                                generator=generator, device=device or env.device)
        self.optimizer = torch.optim.Adam(self.policy.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)

    def rollout_loss(self, state):
        """(loss, rewards (H, B)) of the policy's H macro steps from ``state``."""
        rewards = []
        for _ in range(self.horizon):
            action = torch.tanh(self.policy(self.env.get_obs(state)))
            _, reward, _, info = self.env.step_diff(action, state)
            state = info["state"]
            rewards.append(reward)
        rewards = torch.stack(rewards)
        return -rewards.sum(0).mean(), rewards

    def step(self, state):
        """One update of the policy in place; returns the rewards (H, B) of
        the policy before it."""
        self.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, rewards = self.rollout_loss(state)
            loss.backward()
        for p in self.policy.parameters():
            p.grad = torch.nan_to_num(p.grad)
        self.optimizer.step()
        return rewards.detach()

    def solve(self, state, n_iters=100, verbose=False):
        """``n_iters`` updates from ``state``; returns (the policy, the mean
        total reward of each update's rollout)."""
        history = []
        for it in range(n_iters):
            history.append(float(self.step(state).sum(0).mean()))
            if verbose and it % 10 == 0:
                print(f"  solver_nn it {it}: reward {history[-1]:.4f}")
        return self.policy, history


def generate_experts(env, out_dir, n_instances, horizon, solver_iters=50, param_ranges=None,
                     seed=0, lr=0.02, draws=None):
    """The expert-data factory: for each instance, reset the env, draw each
    material field of ``param_ranges`` (name -> (lo, hi): ``mu``,
    ``lamda``, ``yield_stress`` on an MPM env, ``stiffness`` on cloth) per
    env as ``lo + (hi - lo) u`` into the state, solve with a
    ``TrajectorySolver`` (``lr``, ``solver_iters`` iterations) and roll its
    best actions forward; pickle ``expert_{inst:04d}.pkl`` in ``out_dir``
    with JAX's keys (``action``, ``reward``, ``params``, ``pc_before``,
    ``pc_after``, ``seed``, ``instance``) as numpy arrays, and return the
    records.

    The reset's generator, each field's uniforms u (B,) and the initial
    actions (N(0, 0.01^2)) come from a CPU generator seeded with ``seed``
    (the record's), unless ``draws`` (one dict per instance:
    ``u`` {name: (B,) uniforms}, ``actions`` (B, horizon, A)) replays them,
    as the parity tests feed JAX's draws to both packages."""
    os.makedirs(out_dir, exist_ok=True)
    solver = TrajectorySolver(env, horizon, lr=lr)
    generator = torch.Generator().manual_seed(seed)
    param_ranges = param_ranges or {}
    B = env.batch_size
    x_of = getattr(env, "packed_x", None)

    def cloud(s):
        return (x_of(s) if x_of else s.x).detach().cpu().numpy()

    records = []
    for inst in range(n_instances):
        reset_seed = int(torch.randint(2**31 - 1, (), generator=generator))
        _, state = env.reset(torch.Generator().manual_seed(reset_seed))
        drawn = {}
        for name, (lo, hi) in param_ranges.items():
            leaf = getattr(state, name)
            u = (torch.rand(B, generator=generator) if draws is None
                 else torch.tensor(np.asarray(draws[inst]["u"][name], np.float32)))
            draw = u * (hi - lo) + lo
            value = draw.to(device=leaf.device, dtype=leaf.dtype).view(B, *[1] * (leaf.dim() - 1))
            state = state.replace(**{name: value.expand_as(leaf).contiguous()})
            drawn[name] = draw.numpy()
        actions = (solver.init_actions(generator) if draws is None
                   else torch.as_tensor(np.asarray(draws[inst]["actions"], np.float32),
                                        device=env.device))
        pc_before = cloud(state)
        best, best_reward, _ = solver.solve(state, n_iters=solver_iters, actions=actions)
        with torch.no_grad():
            s = state
            for t in range(horizon):
                _, _, _, info = env.step_diff(best[:, t], s)
                s = info["state"]
        rec = {
            "action": best.cpu().numpy(),
            "reward": best_reward.cpu().numpy(),
            "params": drawn,
            "pc_before": pc_before,
            "pc_after": cloud(s),
            "seed": seed,
            "instance": inst,
        }
        with open(os.path.join(out_dir, f"expert_{inst:04d}.pkl"), "wb") as f:
            pickle.dump(rec, f)
        records.append(rec)
        print(f"expert {inst}: reward {rec['reward'].mean():.4f} params "
              + " ".join(f"{k}={v.mean():.3g}" for k, v in drawn.items()))
    return records
