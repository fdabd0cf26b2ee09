"""The benchmark of morl_baselines_torch (see harness.py)."""
