"""Unified algorithm dispatcher, counterpart of
``unidom_tpu/algorithms/solve.py``:

    python -m unidom_torch.algorithms.solve --algo action --env_name plb_move \\
        --batch_size 16 --horizon 10 --iters 4

``action`` is gradient trajectory optimisation (``TrajectorySolver``),
``nn`` a policy optimised through the simulator (``SolverNN``), ``apg`` the
APG trainer (``algorithms/apg.train``). The RL baselines ``ppo``, ``sac``,
``discor`` and ``td3`` are not ported yet and raise. Runs on the card
unless ``--device cpu``.
"""

import argparse

import torch

# the arms not ported yet, and the ROADMAP step that ports them
NOT_PORTED = {"ppo": "Step 14 (RL)", "sac": "Step 14 (RL)", "discor": "Step 14 (RL)",
              "td3": "Step 14 (RL)"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="action",
                   choices=["action", "nn", "ppo", "sac", "discor", "td3", "apg"])
    p.add_argument("--env_name", default="shape_rope")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--horizon", type=int, default=6)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain simulator steps on the host")
    a = p.parse_args(argv)

    if a.algo in NOT_PORTED:
        raise NotImplementedError(f"--algo {a.algo} is not ported yet: ROADMAP {NOT_PORTED[a.algo]}")
    if a.algo == "apg":
        from unidom_torch.algorithms.apg import train

        return train(env_name=a.env_name, episode_length=a.horizon, num_envs=a.batch_size,
                     max_it=a.iters, seed=a.seed, device=a.device)

    from unidom_torch.algorithms.solver import SolverNN, TrajectorySolver
    from unidom_torch.envs.registration import env_functions

    env = env_functions[a.env_name](batch_size=a.batch_size, seed=a.seed, device=a.device)
    _, state = env.reset(torch.Generator().manual_seed(a.seed))
    if a.algo == "nn":
        solver = SolverNN(env, a.horizon, lr=a.lr or 1e-3,
                          generator=torch.Generator().manual_seed(a.seed))
        policy, history = solver.solve(state, n_iters=a.iters, verbose=True)
        print("final reward:", history[-1])
        return policy, history
    solver = TrajectorySolver(env, a.horizon, lr=a.lr or 0.02)
    actions, reward, history = solver.solve(state, n_iters=a.iters, verbose=True)
    print("final reward:", reward.cpu().numpy())
    return actions, reward, history


if __name__ == "__main__":
    main()
