"""Gradient-based trajectory optimisation through the differentiable
simulator: batched shooting of open-loop action sequences.

Counterpart of ``unidom_tpu/algorithms/solver.py``'s ``TrajectorySolver``:
the action sequence is a (B, H, A) tensor, B independent problems solved at
once, optimised with Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8)
through autograd of H ``env.step_diff`` calls. Each update takes the
rollout's loss (minus the mean over envs of the summed rewards), its
gradient with ``nan_to_num``, Adam's step and a clamp to the action bounds.
On the card every macro step's gradient goes through the simulator's
backward kernels. (The JAX solver's momentum optimiser and custom loss have
no caller and are not ported.)

``SolverNN`` (a policy network optimised through the simulator) and
``generate_experts`` (the expert-data factory) are not ported yet.
"""

import torch


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
