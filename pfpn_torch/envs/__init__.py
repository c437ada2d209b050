from .gym_adapter import Box, Env, GymEnv  # noqa: F401
