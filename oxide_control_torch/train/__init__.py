"""RL consumers of the rollout kernel's trajectories: PPO (``train.ppo``)
and antithetic evolution strategies (``train.es``) on cheetah-run, the
ports of the reference's ``examples/train_ppo.py`` and
``examples/train_es.py``."""
