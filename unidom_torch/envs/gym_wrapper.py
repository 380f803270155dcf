"""Gym-flavoured wrapper over the batched envs.

Counterpart of ``unidom_tpu/envs/gym_wrapper.py``: a numpy reset/step API
without gradients, an automatic reset once every env is done, and the NaN
tripwire: on a NaN in the observation or the reward the wrapper dumps the
action history to a pickle and raises ``NaNError``, instead of the
DaXBench-style silent scrub.

Each reset draws the env's reset seed from the wrapper's own
``torch.Generator`` (seeded by ``reset(seed)``, 0 at first); the JAX
wrapper splits a key instead, so the two draw different resets.
"""

import pickle
import time

import numpy as np
import torch


class NaNError(RuntimeError):
    pass


class GymWrapper:
    def __init__(self, env, nan_fail: bool = True, dump_dir: str = "."):
        self.env = env
        self.nan_fail = nan_fail
        self.dump_dir = dump_dir
        self.batch_size = env.batch_size
        self.observation_size = env.observation_size
        self.action_size = env.action_size
        self._state = None
        self._generator = torch.Generator().manual_seed(0)
        self._action_history = []

    def reset(self, seed=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        draw = int(torch.randint(2**31 - 1, (1,), generator=self._generator))
        obs, self._state = self.env.reset(torch.Generator().manual_seed(draw))
        self.observation_size = self.env.observation_size
        self._action_history = []
        return obs.cpu().numpy()

    @torch.no_grad()
    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions), dtype=torch.float32,
                                  device=self.env.device)
        self._action_history.append(actions.cpu().numpy())
        obs, reward, done, info = self.env.step_diff(actions, self._state)
        self._state = info["state"]

        obs_np, rew_np = obs.cpu().numpy(), reward.cpu().numpy()
        if self.nan_fail and (not np.isfinite(obs_np).all() or not np.isfinite(rew_np).all()):
            path = f"{self.dump_dir}/nan_action_dump_{int(time.time())}.pkl"
            with open(path, "wb") as f:
                pickle.dump(self._action_history, f)
            raise NaNError(f"NaN in obs/reward; action history dumped to {path}")

        done_np = done.cpu().numpy()
        if done_np.all():
            obs_np = self.reset()
        return obs_np, rew_np, done_np, info
